"""The port's composition of the experiment tree against the JAX package's,
on the CPU: the YAML reader against ``yaml.safe_load`` + ``_coerce_numbers``
on every file under ``configs/``, ``compose`` against
``pccf.config.compose.compose`` and ``SliceConfig.from_tree`` against the
fields of ``get_config_all`` over the flagship, ``tests/test_pipeline.py``'s
``TINY``, the model variants, the tuning space's gradient ops and a few
schedule, ``final`` and ``+``/``~`` overrides; the command line's flags and
experiment name.  Exact equality throughout (the values are parsed, not
computed).
"""

import dataclasses
import pathlib

import pytest
import torch
import yaml

from pccf.config import get_config_all
from pccf.config.compose import _coerce_numbers
from pccf.config.compose import compose as jax_compose
from pccf.config.experiment import update_exp_name as jax_update_exp_name
from pccf_torch import cli
from pccf_torch.compose import ComposeError, compose, read_yaml
from pccf_torch.config import SliceConfig
from test_pipeline import TINY

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / 'configs' / 'experiment'
YAML_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / 'configs').rglob('*.yaml'))

CORNER = ['autoencoder/model/encoder=lgcnn', 'autoencoder.model.encoder.conv_dims=[17,130,511]',
          'autoencoder.model.decoder.conv_dims=[500,300,77]', 'autoencoder.model.decoder.map_dims=[200]',
          'autoencoder.model.decoder.sample_dim=32', 'w_autoencoder.model.w_decoder.proj_dim=128',
          'w_autoencoder.model.w_decoder.n_heads=16', 'w_autoencoder.model.w_decoder.mlp_dims=[137]',
          'w_autoencoder.model.w_encoder.proj_dim=256', 'w_autoencoder.model.w_encoder.mlp_dims=[1000]',
          'w_autoencoder.model.conditional_w_encoder.proj_dim=512',
          'w_autoencoder.model.conditional_w_encoder.n_heads=4',
          'w_autoencoder.model.conditional_w_encoder.mlp_dims=[700]']
OVERRIDE_SETS = {
    'flagship': [],
    'tiny': TINY,
    'ldgcnn': ['autoencoder/model/encoder=lgcnn'],
    'conv_linear': ['w_autoencoder/model/w_encoder=convolutional_w_encoder',
                    'w_autoencoder/model/w_decoder=linear_w_decoder'],
    'vamp': ['w_autoencoder.model.n_pseudo_inputs=8'],
    'gelu': ['autoencoder.model.encoder.act_name=GELU'],
    'corner': CORNER,
    'grad_norm': ['w_autoencoder.train.learn.grad_op=GradNormClipper'],
    'hist': ['w_autoencoder.train.learn.grad_op=HistClipper'],
    'param_hist': ['w_autoencoder.train.learn.grad_op=ParamHistClipper',
                   'w_autoencoder.train.learn.clip_criterion=ZStat'],
    'schedules': ['autoencoder/train/learn/scheduler=exponential', 'classifier/train/learn/scheduler=constant',
                  'w_autoencoder.train.learn.learning_rate=1e-04'],
    'final_seed': ['final=true', 'user.seed=3', 'user.load_checkpoint=-1', '+user.extra=[1, 2]', '~user.export'],
    'wide_heads': ['w_autoencoder.model.w_encoder.n_heads=2',
                   'autoencoder.model.decoder.conv_dims=[512,256,128,64,32]'],
    'adam_rmsprop': ['autoencoder.train.learn.optimizer_name=Adam', '+autoencoder.train.learn.opt_settings.b2=0.99',
                     'w_autoencoder.train.learn.optimizer_name=RMSprop',
                     '+w_autoencoder.train.learn.opt_settings.centered=true',
                     '+w_autoencoder.train.learn.opt_settings.momentum=0.5',
                     'classifier.train.learn.optimizer_name=RMSprop'],
}


@pytest.mark.parametrize('path', YAML_FILES)
def test_reader_equals_pyyaml(path):
    text = (ROOT / path).read_text()
    assert read_yaml(text) == _coerce_numbers(yaml.safe_load(text))


@pytest.mark.parametrize('text', [
    "a: 1\nb: [1, 'x', \"y\", {}]\nc:\n- 1\n- k: v\n  j: 2\n- [3]\n", 'd: 0x1F\ne: 010\nf: 1_000\ng: .5\nh: -.inf\n',
    "i: yes\nj: 'it''s'\nk: a:b\nl: {a: 1, b: [2, 3]}\nm: ~\nn: 1.5e+3\no: 2e5\np: 'x # y' # c\n",
    'x:\n  - a: 1\n    b:\n      c: 2\n  - 3\n', '[8,16]', '-1', 'Chamfer', 'off', '', 'null', '5.', "'[1]'",
])
def test_reader_equals_pyyaml_on_scalars_and_nesting(text):
    assert read_yaml(text) == _coerce_numbers(yaml.safe_load(text))


def test_reader_refuses_what_it_does_not_read():
    for text in ('a: &x 1\nb: *x\n', 'a: |\n  text\n', '---\na: 1\n---\nb: 2\n'):
        with pytest.raises(ComposeError):
            read_yaml(text)


@pytest.mark.parametrize('name', OVERRIDE_SETS)
def test_compose_equals_jax(name):
    overrides = OVERRIDE_SETS[name]
    assert compose(CONFIG_DIR, 'defaults', overrides) == jax_compose(CONFIG_DIR, 'defaults', overrides)


def test_compose_tuning_tree_equals_jax():
    for stage in ('autoencoder', 'w_autoencoder'):
        d = ROOT / 'configs' / 'tuning' / stage
        assert compose(d, 'defaults', ['tune=learn']) == jax_compose(d, 'defaults', ['tune=learn'])


@pytest.mark.parametrize('bad', [['data/datset=synthetic'], ['user.sed=1'], ['~user.nothing'], ['user.seed']])
def test_compose_refuses_as_jax_does(bad):
    from pccf.config.compose import ComposeError as JaxComposeError

    with pytest.raises(JaxComposeError):
        jax_compose(CONFIG_DIR, 'defaults', bad)
    with pytest.raises(ComposeError):
        compose(CONFIG_DIR, 'defaults', bad)


def _jax_fields(cfg) -> dict:
    """The JAX configuration's values of the fields the port reads."""
    d, c, a, w, u = cfg.data, cfg.classifier, cfg.autoencoder, cfg.w_autoencoder, cfg.user

    def learn(exp):
        ln, tr = exp.train.learn, exp.train
        s = ln.scheduler
        return (tr.batch_size, tr.n_epochs, ln.optimizer_name, ln.learning_rate,
                ln.opt_settings.get('weight_decay', 0.0),
                {k: v for k, v in ln.opt_settings.items() if k != 'weight_decay'}
                if ln.optimizer_name in ('Adam', 'RMSprop') else {},
                ln.grad_op and str(ln.grad_op), str(ln.clip_criterion),
                (str(s.function), s.restart_interval, s.restart_fraction, s.warmup_steps, dict(s.settings)),
                (tr.early_stopping.active, tr.early_stopping.window, tr.early_stopping.patience))

    def net(n):
        return (str(n.class_name), n.proj_dim, n.n_heads, tuple(n.mlp_dims), n.act_name, tuple(n.dropout_rates),
                tuple(n.conv_dims))

    return {
        'data': (d.n_input_points, d.n_target_points, d.n_neighbors, d.dataset.n_classes, d.translate, d.rotate,
                 d.jitter_sigma, d.jitter_clip, d.resample, str(d.dataset.name), dict(d.dataset.settings)),
        'classifier': (c.model.name, c.model.n_neighbors, tuple(c.model.conv_dims), c.model.act_name,
                       tuple(c.model.dropout_rates), c.model.feature_dim, tuple(c.model.mlp_dims), learn(c),
                       c.train.learn.opt_settings.get('momentum', 0.0) if c.train.learn.optimizer_name == 'SGD'
                       else 0.0),
        'autoencoder': (a.model.name, str(a.model.class_name), a.model.book_size, a.model.embedding_dim,
                        a.model.w_dim, a.model.vq_noise, a.diagnose_every, str(a.model.encoder.class_name),
                        tuple(a.model.encoder.conv_dims), a.model.encoder.act_name, a.model.decoder.sample_dim,
                        a.model.decoder.n_components, tuple(a.model.decoder.map_dims),
                        tuple(a.model.decoder.conv_dims), a.model.decoder.tau, a.model.decoder.act_name,
                        a.model.decoder.filter, str(a.objective.recon_loss), a.objective.c_embedding, learn(a)),
        'w_autoencoder': (w.model.name, w.model.z1_dim, w.model.z2_dim, w.model.cf_temperature,
                          w.model.n_pseudo_inputs, net(w.model.w_encoder), net(w.model.w_decoder),
                          net(w.model.conditional_w_encoder), w.objective.c_kld1, w.objective.c_kld2, learn(w)),
        'user': (u.counterfactual_value, (u.generate.batch_size, u.generate.bias_dim, u.generate.bias_value), u.seed,
                 u.cpu, u.n_workers, u.checkpoint_every, u.load_checkpoint,
                 tuple(getattr(u.trackers, k) for k in ('hydra', 'tensorboard', 'wandb', 'sqlalchemy', 'csv'))),
        'run': (cfg.variation, cfg.final, cfg.name),
    }


def _port_fields(cfg: SliceConfig) -> dict:
    d, c, a, w, u = cfg.data, cfg.classifier, cfg.autoencoder, cfg.w_autoencoder, cfg.user

    def settings(s):
        return {k: list(v) if isinstance(v, tuple) else v for k, v in s}

    def learn(t):
        s = t.scheduler
        sched = {'Cosine': {'min_decay': s.min_decay, 'decay_steps': s.decay_steps},
                 'Exponential': {'exp_decay': s.exp_decay}, 'Constant': {}}[s.function]
        return (t.batch_size, t.n_epochs, t.optimizer_name, t.learning_rate, t.weight_decay, dict(t.opt_settings),
                t.grad_op,
                t.clip_criterion, (s.function, s.restart_interval, s.restart_fraction, s.warmup_steps, sched),
                (t.early_stopping.active, t.early_stopping.window, t.early_stopping.patience))

    def net(n):
        return (n.class_name, n.proj_dim, n.n_heads, n.mlp_dims, n.act_name, n.dropout_rates, n.conv_dims)

    return {
        'data': (d.n_input_points, d.n_target_points, d.n_neighbors, d.n_classes, d.translate, d.rotate,
                 d.jitter_sigma, d.jitter_clip, d.resample, d.dataset_name, settings(d.dataset_settings)),
        'classifier': (c.name, c.n_neighbors, c.conv_dims, c.act_name, c.dropout_rates, c.feature_dim, c.mlp_dims,
                       learn(c.train), c.train.momentum),
        'autoencoder': (a.name, a.class_name, a.book_size, a.embedding_dim, a.w_dim, a.vq_noise, a.diagnose_every,
                        a.encoder.class_name, a.encoder.conv_dims, a.encoder.act_name, a.decoder.sample_dim,
                        a.decoder.n_components, a.decoder.map_dims, a.decoder.conv_dims, a.decoder.tau,
                        a.decoder.act_name, a.decoder.filter, a.train.recon_loss, a.train.c_embedding,
                        learn(a.train)),
        'w_autoencoder': (w.name, w.z1_dim, w.z2_dim, w.cf_temperature, w.n_pseudo_inputs, net(w.w_encoder),
                          net(w.w_decoder), net(w.conditional_w_encoder), w.train.c_kld1, w.train.c_kld2,
                          learn(w.train)),
        'user': (u.counterfactual_value, (u.generate.batch_size, u.generate.bias_dim, u.generate.bias_value), u.seed,
                 u.cpu, u.n_workers, u.checkpoint_every, u.load_checkpoint,
                 tuple(getattr(u.trackers, k) for k in ('hydra', 'tensorboard', 'wandb', 'sqlalchemy', 'csv'))),
        'run': (cfg.variation, cfg.final, cfg.name),
    }


@pytest.mark.parametrize('name', OVERRIDE_SETS)
def test_from_tree_equals_get_config_all(name):
    overrides = OVERRIDE_SETS[name]
    port, _ = cli.get_config(overrides)
    want, got = _jax_fields(get_config_all(overrides)), _port_fields(port)
    for key in want:
        assert got[key] == want[key], key


def test_from_tree_of_the_flagship_is_the_flagship():
    assert cli.get_config([])[0] == SliceConfig()


def test_from_tree_refuses_what_the_port_does_not_run():
    with pytest.raises(NotImplementedError, match='n_subprocesses'):
        cli.get_config(['user.n_subprocesses=2'])
    with pytest.raises(NotImplementedError, match='nesterov'):
        cli.get_config(['classifier.train.learn.optimizer_name=Adam',
                        '+classifier.train.learn.opt_settings.nesterov=true'])
    with pytest.raises(ValueError, match='alpha'):
        cli.get_config(['classifier.train.learn.optimizer_name=RMSprop',
                        '+classifier.train.learn.opt_settings.alpha=0.9'])
    with pytest.raises(ValueError, match='n_neighbours|neighbours'):
        cli.get_config(['autoencoder.model.encoder.n_neighbors=7'])


def test_argv_flags_and_experiment_name_equal_jax():
    """``--config-dir``/``--config-name`` in both spellings, and the
    overrides folded into the name and tags as ``hydra_main`` folds them."""
    argv = ['--config-dir', str(CONFIG_DIR), '--config-name=defaults', *TINY[:6]]
    config_dir, config_name, overrides = cli.split_argv(argv)
    assert (pathlib.Path(config_dir), config_name, overrides) == (CONFIG_DIR, 'defaults', TINY[:6])
    assert cli.update_exp_name('main', overrides) == jax_update_exp_name('main', overrides)
    cfg, tree = cli.parse_args(argv)
    assert cfg.variation == jax_update_exp_name('main', overrides)[0] and list(cfg.tags) == overrides
    assert tree['variation'] == cfg.variation and cfg.name == cfg.variation
    assert dataclasses.replace(cfg, final=True).name == f'{cfg.variation}_final'
    with pytest.raises(SystemExit):
        cli.split_argv(['--config-dri', 'x'])


def test_device_is_the_card_unless_user_cpu(monkeypatch):
    cfg = cli.get_config(['user.cpu=true'])[0]
    assert cli.device(cfg) == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.device(cli.get_config([])[0])

"""``tools/import_orbax.py`` on the CPU: JAX checkpoints into the port's layout.

The JAX package builds the classifier, the stage-1 VQ-VAE and stage 2's
``WAETrainModule`` shell at ``tests/test_pipeline.py``'s ``TINY`` size, its
own ``Trainer`` makes the optimiser (``_make_tx``: the gradient operation
chained before the optimiser, raveled by ``optax.flatten`` unless
``PCCF_FLAT_OPT=0``, stage 1 under ``multi_transform`` with the inner CVAE
frozen), two updates on random gradients move the parameters and the
state, and ``pccf.train.model.Checkpoint`` with the trainer's sidecar saves
them (``runners.py:441-454``).  The importer writes the port's checkpoints,
and a port ``Trainer`` resumes from them.

Checked: the weights bit-equal to ``flax_to_state_dict`` of the saved
variables (strict load); the step; one further update on one more random
gradient equal to one further JAX update (``tx.update``) at the stage-step
tests' tolerances (rel 1e-5, abs 1e-6: the same float32 elementwise
optimiser arithmetic in another order), the frozen inner CVAE unmoved; the
gradient operation's statistics after it; and the imported models' eval
outputs against JAX's at the slice parity tests' tolerances (logits 1e-4,
VQ codes as agreement >= 0.99, the clouds of agreeing codes 1e-4).  The
gradient is handed to both, so the step checks the state's import; the
forward and backward are the stage-step tests' business.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pccf_torch import cli
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.protocols import Singleton
from pccf_torch.data.structures import Inputs
from pccf_torch.experiment import Experiment
from test_pipeline import TINY

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'tools'))
import import_orbax  # noqa: E402

torch.set_num_threads(1)

STEPS_PER_EPOCH = 2
EPOCH = 1
UPDATE = dict(rtol=1e-5, atol=1e-6)
N_POINTS = 64  # TINY's


@pytest.fixture()
def roots(tmp_path, monkeypatch):
    Singleton.reset_all()
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    yield tmp_path
    Singleton.reset_all()


def _clouds(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, N_POINTS, 3)) / 2).astype(np.float32)


def _jax_model(kind, jcfg):
    """The flax module, its initial variables, objective and learning schema."""
    from pccf.data.structures import Inputs as JInputs, WInputs as JWInputs
    from pccf.models import get_autoencoder
    from pccf.models.w_autoencoders import WAETrainModule, get_w_autoencoder
    from pccf.nn import get_classifier
    from pccf.train import get_autoencoder_loss, get_classification_loss, get_learning_schema, get_w_autoencoder_loss

    cloud = jnp.asarray(_clouds(2, 0))
    if kind == 'classifier':
        m = get_classifier(jcfg)
        v = m.init(jax.random.key(1), JInputs(cloud=cloud))
        return m, v, get_classification_loss(), get_learning_schema(jcfg.classifier)
    if kind == 'autoencoder':
        m = get_autoencoder(jcfg)
        v = m.init({'params': jax.random.key(2), 'sampling': jax.random.key(3)}, JInputs(cloud=cloud),
                   jnp.zeros((2, 2)), method='full_init')
        return m, v, get_autoencoder_loss(jcfg), get_learning_schema(jcfg.autoencoder)
    am = jcfg.autoencoder.model
    t, e = am.w_dim // am.embedding_dim, am.embedding_dim
    m = WAETrainModule(wae=get_w_autoencoder(jcfg, conditional=True))
    v = m.init({'params': jax.random.key(4), 'sampling': jax.random.key(5)}, JWInputs(jnp.zeros((1, t * e)),
                                                                                       jnp.zeros((1, 2))), train=False)
    v = {**v, 'constants': {'codebook': jnp.asarray(np.random.default_rng(6).standard_normal(
        (t, am.book_size, e)).astype(np.float32))}}
    return m, v, get_w_autoencoder_loss(jcfg), get_learning_schema(jcfg.w_autoencoder)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)


def _save_jax_run(kind, overrides, src_root):
    """Two updates of the JAX trainer's optimiser on random gradients, saved as
    the JAX trainer saves them; returns what the test needs of the JAX side."""
    from pccf.config import get_config_all
    from pccf.config.experiment import Experiment as JExperiment
    from pccf.dist import get_mesh
    from pccf.train import Model, Trainer as JTrainer
    from pccf.train.runners import TrainState

    jcfg = get_config_all(overrides)
    name = getattr(cli.get_config(overrides)[0], kind).name
    module, v, loss, schema = _jax_model(kind, jcfg)
    loader = types.SimpleNamespace(batch_size=4, n_batches=lambda inference=False: STEPS_PER_EPOCH)
    frozen = ('w_autoencoder',) if kind == 'autoencoder' else ()
    exp = JExperiment(jcfg, name='jax', par_dir=src_root)
    with exp.create_run(record=False):
        model = Model(module, name, variables=v)
        jt = JTrainer(model, loader, loss, schema, frozen=frozen, mesh=get_mesh(1))
        tx = jt._make_tx()
        params, state = v['params'], tx.init(v['params'])
        for k in range(2):
            updates, state = tx.update(_grads(params, 10 + k), state, params)
            params = optax.apply_updates(params, updates)
        model.variables = {**v, 'params': params}
        model.epoch = EPOCH
        jt._state = TrainState(params=params, batch_stats=v.get('batch_stats', {}), opt_state=state,
                               step=jnp.asarray(2, jnp.int32))
        jt.save_checkpoint()
    return types.SimpleNamespace(module=module, variables=model.variables, tx=tx, state=state, name=name,
                                 src=exp.exp_dir)


CASES = {
    'classifier-SGD-momentum-flat': ('classifier', ['+classifier.train.learn.opt_settings.momentum=0.9'], True),
    'classifier-Adam-per-leaf': ('classifier', ['classifier.train.learn.optimizer_name=Adam'], False),
    'classifier-RMSprop-centred-momentum-flat': (
        'classifier', ['classifier.train.learn.optimizer_name=RMSprop',
                       '+classifier.train.learn.opt_settings.momentum=0.5',
                       '+classifier.train.learn.opt_settings.centered=true'], True),
    'autoencoder-AdamW-multi-transform': ('autoencoder', [], False),
    'stage2-AdamW-ParamHistClipper-flat': ('w_autoencoder', [], True),
    'stage2-AdamW-HistClipper-per-leaf': ('w_autoencoder', ['w_autoencoder.train.learn.grad_op=HistClipper'], False),
}


@pytest.mark.parametrize('case', list(CASES))
def test_imported_sidecar_resumes_to_the_jax_step(roots, monkeypatch, case):
    from pccf_torch.train import Trainer

    kind, extra, flat = CASES[case]
    if not flat:
        monkeypatch.setenv('PCCF_FLAT_OPT', '0')
    overrides = [*TINY, 'user.cpu=true', *extra]
    jax_run = _save_jax_run(kind, overrides, roots / 'jax')
    raw = import_orbax.restore(jax_run.src / 'models' / jax_run.name / 'checkpoints' / f'epoch_{EPOCH}_opt')
    _, opt = import_orbax.split_chain(raw['opt_state'])
    leaf = next(s for s in import_orbax._states(opt) if {'mu', 'nu', 'trace'} & set(s))
    moment = next(leaf[k] for k in ('mu', 'nu', 'trace') if k in leaf)
    assert isinstance(moment, dict) != flat  # the case stores the state as it says

    dst = roots / 'port' / 'imported'
    assert import_orbax.main([str(jax_run.src), *overrides, '--dst', str(dst)]) == {jax_run.name: [EPOCH]}

    cfg = cli.get_config(overrides)[0]
    model, tcfg, objective, prefix = import_orbax.build(kind, cfg)
    with Experiment(cfg, name=dst.name, par_dir=dst.parent).create_run(record=False):
        trainer = Trainer(model, objective, tcfg, STEPS_PER_EPOCH, seed=3, name=jax_run.name)
        trainer.load_checkpoint(EPOCH)
    assert trainer.epoch == EPOCH and trainer.step == 2
    want = {prefix + k: v for k, v in flax_to_state_dict(jax.device_get(jax_run.variables)).items()}
    got = model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(trainer.generator.get_state(), torch.Generator().manual_seed(0).get_state())

    # one more update on both sides from the same gradient
    params = jax_run.variables['params']
    g = _grads(params, 12)
    updates, state = jax_run.tx.update(g, jax_run.state, params)
    after = flax_to_state_dict({'params': optax.apply_updates(params, updates)})
    grads = flax_to_state_dict({'params': g})
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith('w_autoencoder.')}
    for n, p in model.named_parameters():
        p.grad = grads[n[len(prefix):]].clone() if p.requires_grad else None
    for group in trainer.optimizer.param_groups:
        group['lr'] = trainer.lr_at(trainer.step)
    if trainer.grad_op is not None:
        trainer.grad_op()
    trainer.optimizer.step()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in frozen:
                assert torch.equal(p, frozen[n]), n
            else:
                np.testing.assert_allclose(p.numpy(), after[n[len(prefix):]].numpy(), err_msg=n, **UPDATE)
    if trainer.grad_op is not None and trainer.grad_op.state_dict():
        grad_state = jax.device_get(state)[0]  # optax.chain(grad_op, optimizer)
        mean = grad_state.mean
        if isinstance(mean, dict):
            mean = import_orbax.scalars_by_name(mean, params, prefix)
            want_mean = [mean[n] for n in trainer.grad_op.names]
        else:
            want_mean = [float(mean)]
        np.testing.assert_allclose(trainer.grad_op.mean.numpy(), want_mean, rtol=1e-5)
        assert trainer.grad_op.seen == int(grad_state.seen) == 3


def test_imported_models_evaluate_as_jax(roots):
    """The classifier's logits and the VQ-VAE's counterfactuals from the
    imported checkpoints against the JAX models on the saved variables."""
    from pccf.data.structures import Inputs as JInputs
    from pccf.kernels import api as japi
    from pccf_torch.train.checkpoint import Checkpoint

    overrides = [*TINY, 'user.cpu=true']
    runs = {kind: _save_jax_run(kind, overrides, roots / 'jax') for kind in ('classifier', 'autoencoder')}
    dst = roots / 'port' / 'imported'
    import_orbax.main([str(runs['classifier'].src), *overrides, '--dst', str(dst)])
    cfg = cli.get_config(overrides)[0]
    clouds = _clouds(3, 7)
    sampling = np.random.default_rng(8).standard_normal((3, N_POINTS, 4)).astype(np.float32)
    shell, _, _, _ = import_orbax.build('classifier', cfg)
    vqvae, _, _, _ = import_orbax.build('autoencoder', cfg)
    with Experiment(cfg, name=dst.name, par_dir=dst.parent).create_run(record=False):
        assert Checkpoint(runs['classifier'].name).load(shell) == EPOCH
        assert Checkpoint(runs['autoencoder'].name).load(vqvae) == EPOCH
    with japi.force_backend('jnp'):
        jr = runs['classifier']
        want = np.asarray(jr.module.apply(jr.variables, JInputs(cloud=jnp.asarray(clouds)), train=False))
        vr = runs['autoencoder']
        logits = jnp.asarray(want)
        jcf = vr.module.apply(vr.variables, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)),
                              logits, jnp.asarray([1, 0, 1]), jnp.ones((3, 1)), method='generate_counterfactual')
    with torch.no_grad():
        got = shell.classifier.eval()(Inputs(cloud=torch.from_numpy(clouds))).numpy()
        cf = vqvae.eval().generate_counterfactual(
            Inputs(cloud=torch.from_numpy(clouds), initial_sampling=torch.from_numpy(sampling)),
            torch.from_numpy(want), torch.tensor([1, 0, 1]), torch.ones((3, 1)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    idx, jidx = cf.idx.numpy(), np.asarray(jcf.idx)
    assert (idx == jidx).mean() >= 0.99
    same = (idx == jidx).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(cf.recon.numpy()[same], np.asarray(jcf.recon)[same], rtol=1e-4, atol=1e-4)


def test_a_missing_epoch_raises(roots):
    overrides = [*TINY, 'user.cpu=true']
    run = _save_jax_run('classifier', overrides, roots / 'jax')
    with pytest.raises(FileNotFoundError, match='epoch_5'):
        import_orbax.main([str(run.src), *overrides, '--dst', str(roots / 'port' / 'x'), '--epoch', '5'])

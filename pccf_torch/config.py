"""Flagship configuration of the port's slices, as plain dataclasses.

The JAX package composes its configuration from ``configs/experiment/**`` with
pydantic and pyyaml; the machine that runs the port has neither, so the
values the port needs are restated here, each field citing the yaml it comes
from.  ``tests/test_torch_port_modules.py`` holds these defaults against
``pccf.config.get_config_all([])`` so the two cannot drift apart.
:meth:`SliceConfig.from_tree` reads the same fields from a tree that
:func:`pccf_torch.compose.compose` composed, overrides included; the
flagship tree gives ``SliceConfig()``.  The fields the harness reads (the
run's name, seed and device, the checkpoint cadence, the trackers, early
stopping, the dataset) sit beside the model's, and :func:`paths` gives the
directories ``pccf/config/environment.py`` gives.

The slices cover the flagship unmodified, and the variants of the experiment
tree (the LDGCNN encoder, the convolutional W-encoder, the linear W-decoder,
the VampPrior) through these fields: counterfactual serving with graph
filtering on, stage-1 training of the VQ-VAE under its three reconstruction
objectives (ChamferEMD, the flagship's, and the Chamfer and ChamferSinkhorn
alternatives), stage-2 training of the inner W-autoencoder, classifier
training, the counterfactual evaluation suites and generation from the prior.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Any

VERSION = '0.1.0'  # pccf/config/environment.py:11, the experiments' version directory


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n_input_points: int = 2048  # data/default_data.yaml:5
    n_target_points: int = 2048  # data/default_data.yaml:6
    n_neighbors: int = 25  # data/default_data.yaml:13
    n_classes: int = 2  # data/dataset/modelnet_desk_table.yaml:2
    # the augmentations of a training cloud (pccf/data/modelnet.py:85-103)
    translate: bool = False  # data/default_data.yaml:7
    rotate: bool = False  # data/default_data.yaml:8
    jitter_sigma: float = 0.01  # data/default_data.yaml:9
    jitter_clip: float = 0.01  # data/default_data.yaml:10
    resample: bool = False  # data/default_data.yaml:11
    dataset_name: str = 'ModelNet'  # data/dataset/modelnet_desk_table.yaml:1
    # data/dataset/modelnet_desk_table.yaml:3-4, as (key, value) pairs with lists as tuples
    dataset_settings: tuple[tuple[str, Any], ...] = (('select_classes', ('desk', 'table')),)

    def setting(self, key: str, default: Any = None) -> Any:
        return dict(self.dataset_settings).get(key, default)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """autoencoder/train/learn/scheduler/cosine.yaml; ``function`` names the
    base schedule (Cosine, Constant or Exponential) and ``exp_decay`` is the
    Exponential one's setting."""

    restart_interval: int = 100
    restart_fraction: float = 1.0
    warmup_steps: int = 0
    min_decay: float = 0.01
    decay_steps: int = 100
    function: str = 'Cosine'
    exp_decay: float = 0.975  # scheduler/exponential.yaml


@dataclasses.dataclass(frozen=True)
class EarlyStoppingConfig:
    """``<stage>/train/early_stopping/default_early_stopping.yaml``."""

    active: bool = False
    window: int = 1
    patience: int = 10


CLASSIFIER_EPOCHS = 45  # classifier/train/default_train.yaml:7


@dataclasses.dataclass(frozen=True)
class ClassifierTrainConfig:
    """classifier/train/**: SGD with the cosine schedule, no gradient operation."""

    batch_size: int = 16  # train/default_train.yaml:6
    n_epochs: int = CLASSIFIER_EPOCHS  # train/default_train.yaml:7
    optimizer_name: str = 'SGD'  # train/learn/default_learn.yaml:5
    learning_rate: float = 0.01  # train/learn/default_learn.yaml:6
    momentum: float = 0.0  # train/learn/default_learn.yaml sets none: optax.sgd without momentum (specs.py:81-84)
    weight_decay: float = 0.0  # train/learn/default_learn.yaml:10
    opt_settings: tuple[tuple[str, Any], ...] = ()  # Adam's or RMSprop's optax settings (OPT_SETTINGS)
    grad_op: str | None = None  # train/learn/default_learn.yaml:7
    clip_criterion: str = 'ZStat'  # train/learn/default_learn.yaml:8
    # train/learn/scheduler/cosine.yaml: restart and decay over n_epochs, no warmup
    scheduler: SchedulerConfig = SchedulerConfig(restart_interval=CLASSIFIER_EPOCHS, min_decay=0.01,
                                                 decay_steps=CLASSIFIER_EPOCHS)
    early_stopping: EarlyStoppingConfig = EarlyStoppingConfig(active=True, window=5, patience=10)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str = 'DGCNN'  # classifier/model/dgcnn.yaml:1, the checkpoint directory's name
    n_neighbors: int = 20  # classifier/model/dgcnn.yaml:3
    conv_dims: tuple[int, ...] = (64, 64, 128, 256)  # classifier/model/dgcnn.yaml:4
    act_name: str = ''  # classifier/model/dgcnn.yaml:5 (LeakyReLU 0.2)
    dropout_rates: tuple[float, ...] = (0.5, 0.5)  # classifier/model/dgcnn.yaml:6
    feature_dim: int = 512  # classifier/model/dgcnn.yaml:7
    mlp_dims: tuple[int, ...] = (512, 256)  # classifier/model/dgcnn.yaml:8
    train: ClassifierTrainConfig = ClassifierTrainConfig()


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # autoencoder/model/encoder/dgcnn.yaml:1; 'LDGCNN' with encoder=lgcnn
    class_name: str = 'DGCNN'
    # the DGCNN block widths are hard-coded in the reference (encoders.py:165),
    # not read from autoencoder/model/encoder/dgcnn.yaml's conv_dims
    h_dim: tuple[int, ...] = (64, 64, 128, 256)
    # the LDGCNN's widths (lgcnn.yaml:3; dgcnn.yaml:3 has the same, unread)
    conv_dims: tuple[int, ...] = (16, 128, 512, 512)
    act_name: str = ''  # autoencoder/model/encoder/dgcnn.yaml:4


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    sample_dim: int = 8  # autoencoder/model/decoder/pcgen.yaml:2
    n_components: int = 8  # autoencoder/model/decoder/pcgen.yaml:3
    map_dims: tuple[int, ...] = (64,)  # autoencoder/model/decoder/pcgen.yaml:4
    conv_dims: tuple[int, ...] = (1024, 256, 16)  # autoencoder/model/decoder/pcgen.yaml:5
    tau: float = 5.0  # autoencoder/model/decoder/pcgen.yaml:6
    act_name: str = 'ReLU'  # autoencoder/model/decoder/pcgen.yaml:7
    filter: bool = True  # autoencoder/model/decoder/pcgen.yaml:8


@dataclasses.dataclass(frozen=True)
class TransformerNetConfig:
    """One W-net (w_autoencoder/model/{w_encoder,w_decoder,conditional_w_encoder}/*.yaml).
    ``class_name`` 'Transformer' reads the transformer fields; the W-encoder's
    'Convolutional' reads ``conv_dims`` (convolutional_w_encoder.yaml), the
    W-decoder's 'Linear' ``mlp_dims``, ``dropout_rates`` and ``act_name``
    (linear_w_decoder.yaml)."""

    proj_dim: int = 512
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 1024)
    act_name: str = 'GELU'
    dropout_rates: tuple[float, ...] = (0.0,) * 5  # one per layer, the rest unread
    class_name: str = 'Transformer'
    conv_dims: tuple[int, ...] = ()


W_EPOCHS = 500  # w_autoencoder/train/default_train.yaml:7


@dataclasses.dataclass(frozen=True)
class WAutoEncoderTrainConfig:
    """Stage 2: w_autoencoder/train/** and w_autoencoder/objective/vae_objective.yaml."""

    batch_size: int = 32  # train/default_train.yaml:6
    n_epochs: int = W_EPOCHS  # train/default_train.yaml:7; also the KLD annealing length
    optimizer_name: str = 'AdamW'  # train/learn/default_learn.yaml:5
    learning_rate: float = 0.0014  # train/learn/default_learn.yaml:6
    weight_decay: float = 0.001  # train/learn/default_learn.yaml:10 (AdamW, :5)
    opt_settings: tuple[tuple[str, Any], ...] = ()  # Adam's or RMSprop's optax settings (OPT_SETTINGS)
    grad_op: str | None = 'ParamHistClipper'  # train/learn/default_learn.yaml:7
    clip_criterion: str = 'EMA'  # train/learn/default_learn.yaml:8
    # train/learn/scheduler/cosine.yaml: restart and decay over n_epochs, warmup 6
    scheduler: SchedulerConfig = SchedulerConfig(
        restart_interval=W_EPOCHS, warmup_steps=6, min_decay=0.01, decay_steps=W_EPOCHS)
    c_kld1: float = 0.1  # objective/vae_objective.yaml:1
    c_kld2: float = 4.0  # objective/vae_objective.yaml:2
    early_stopping: EarlyStoppingConfig = EarlyStoppingConfig(active=False, window=50, patience=50)


@dataclasses.dataclass(frozen=True)
class WAutoEncoderConfig:
    name: str = 'WAutoEncoder'  # w_autoencoder/model/wae.yaml:7
    z1_dim: int = 16  # w_autoencoder/model/wae.yaml:8
    z2_dim: int = 16  # w_autoencoder/model/wae.yaml:9
    cf_temperature: float = 5.0  # w_autoencoder/model/wae.yaml:10
    n_pseudo_inputs: int = 0  # w_autoencoder/model/wae.yaml:11; > 0 gives the VampPrior
    # w_autoencoder/model/w_encoder/transformer_w_encoder.yaml
    w_encoder: TransformerNetConfig = TransformerNetConfig()
    # w_autoencoder/model/w_decoder/transformer_w_decoder.yaml
    w_decoder: TransformerNetConfig = TransformerNetConfig(mlp_dims=(1024, 1024, 1024, 512),
                                                           dropout_rates=(0.1,) * 5)
    # w_autoencoder/model/conditional_w_encoder/transformer_conditional_w_encoder.yaml
    conditional_w_encoder: TransformerNetConfig = TransformerNetConfig()
    train: WAutoEncoderTrainConfig = WAutoEncoderTrainConfig()


@dataclasses.dataclass(frozen=True)
class AutoEncoderTrainConfig:
    batch_size: int = 8  # autoencoder/train/default_train.yaml:6
    n_epochs: int = 1000  # autoencoder/train/default_train.yaml:7
    optimizer_name: str = 'AdamW'  # autoencoder/train/learn/default_learn.yaml:5
    learning_rate: float = 0.004  # autoencoder/train/learn/default_learn.yaml:6
    weight_decay: float = 0.001  # autoencoder/train/learn/default_learn.yaml:10 (AdamW, :5)
    opt_settings: tuple[tuple[str, Any], ...] = ()  # Adam's or RMSprop's optax settings (OPT_SETTINGS)
    grad_op: str | None = None  # autoencoder/train/learn/default_learn.yaml: none
    clip_criterion: str = 'ZStat'
    scheduler: SchedulerConfig = SchedulerConfig()
    # autoencoder/objective/{chamfer_emd,chamfer,chamfer_sinkhorn}.yaml; the
    # flagship composes chamfer_emd.yaml (autoencoder/autoencoder_exp.yaml:3)
    recon_loss: str = 'ChamferEMD'  # autoencoder/objective/chamfer_emd.yaml:2
    c_embedding: float = 8.0  # autoencoder/objective/chamfer_emd.yaml:3 (the same in the other two)
    early_stopping: EarlyStoppingConfig = EarlyStoppingConfig(active=False, window=10, patience=400)


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    name: str = 'VQVAE'  # autoencoder/model/vqvae.yaml:6
    # autoencoder/model/vqvae.yaml:7; 'VQVAE' gives the unconditional model
    # (uniform class probabilities in the inner CVAE)
    class_name: str = 'CounterfactualVQVAE'
    book_size: int = 16  # autoencoder/model/vqvae.yaml:8
    embedding_dim: int = 4  # autoencoder/model/vqvae.yaml:9
    w_dim: int = 1024  # autoencoder/model/vqvae.yaml:10
    vq_noise: float = 2.0  # autoencoder/model/vqvae.yaml:11 (the codebook hook's noise scale)
    diagnose_every: int = 10  # autoencoder/autoencoder_exp.yaml:8 (epochs between codebook hooks)
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    train: AutoEncoderTrainConfig = AutoEncoderTrainConfig()

    @property
    def n_codes(self) -> int:
        return self.w_dim // self.embedding_dim  # 256 code slots at flagship


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Sampling from the generative prior (``generate.py``)."""

    batch_size: int = 16  # user/user_settings.yaml:26
    bias_dim: int = 0  # user/user_settings.yaml:27, the z1 column ``bias_value`` is added to
    bias_value: float = 0.0  # user/user_settings.yaml:28 (0: no bias)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """user/user_settings.yaml:13-18"""

    hydra: bool = True
    tensorboard: bool = True
    wandb: bool = False
    sqlalchemy: bool = False
    csv: bool = True


@dataclasses.dataclass(frozen=True)
class UserConfig:
    # user/user_settings.yaml:21, how far the suites' counterfactuals move the
    # class probabilities towards the target (1: all the way)
    counterfactual_value: float = 1.0
    generate: GenerateConfig = GenerateConfig()  # user/user_settings.yaml:25
    seed: int | None = None  # user/user_settings.yaml:3
    cpu: bool = False  # user/user_settings.yaml:6; the card unless set
    n_workers: int = 0  # user/user_settings.yaml:7
    checkpoint_every: int = 100  # user/user_settings.yaml:9
    load_checkpoint: int = 0  # user/user_settings.yaml:10: 0 fresh, -1 the latest, n epoch n
    trackers: TrackerConfig = TrackerConfig()


@dataclasses.dataclass(frozen=True)
class Paths:
    """The directories of ``pccf/config/environment.py``: ``ROOT_EXP_DIR``,
    ``DATASET_DIR`` and ``METADATA_DIR`` from the environment, then from a
    ``.env`` file in the working directory, else beside the package."""

    root_exp_dir: pathlib.Path
    data_dir: pathlib.Path
    metadata_dir: pathlib.Path

    @property
    def version_dir(self) -> pathlib.Path:
        return self.root_exp_dir / f'v{VERSION}'


def _dotenv(path: pathlib.Path) -> dict[str, str]:
    if not path.exists():
        return {}
    out = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith('#') and '=' in line:
            k, v = line.split('=', 1)
            out[k.strip()] = v.strip().strip('"').strip("'")
    return out


def paths(dotenv: str | pathlib.Path = '.env') -> Paths:
    file_vars = _dotenv(pathlib.Path(dotenv))
    root = pathlib.Path(__file__).resolve().parents[1]

    def get(key: str, default: pathlib.Path) -> pathlib.Path:
        return pathlib.Path(os.environ.get(key, file_vars.get(key, str(default))))

    return Paths(get('ROOT_EXP_DIR', root / 'experiments'), get('DATASET_DIR', root / 'datasets'),
                 get('METADATA_DIR', root / 'dataset_metadata'))


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    """Everything the serving and training slices read; the defaults are the
    flagship model.  The training step decodes ``data.n_input_points``
    points (``autoencoder/autoencoder_exp.yaml:9``), serving
    ``data.n_target_points``."""

    data: DataConfig = DataConfig()
    classifier: ClassifierConfig = ClassifierConfig()
    autoencoder: AutoEncoderConfig = AutoEncoderConfig()
    w_autoencoder: WAutoEncoderConfig = WAutoEncoderConfig()
    user: UserConfig = UserConfig()
    variation: str = 'main'  # defaults.yaml:10, the experiment's name before the overrides fold in
    final: bool = False  # defaults.yaml:11: train on train + val, test on test, no validation
    tags: tuple[str, ...] = ()

    @property
    def name(self) -> str:
        """The experiment directory's name (``specs.py`` ``AllConfig.name``)."""
        return (f'{self.variation}_final' if self.final else self.variation)[:255]

    @classmethod
    def from_tree(cls, tree: dict) -> 'SliceConfig':
        """The fields of a composed tree (:func:`pccf_torch.compose.compose`),
        as ``pccf/config/specs.py`` validates them.  Raises ``ValueError`` for
        a value the port does not take and ``NotImplementedError`` for what it
        has not ported (``ROADMAP.md``)."""
        d, c, a, w, u = (tree[k] for k in ('data', 'classifier', 'autoencoder', 'w_autoencoder', 'user'))
        if u.get('n_subprocesses'):
            raise NotImplementedError('user.n_subprocesses: data-parallel training is not ported (ROADMAP.md)')
        _check(a['n_training_output_points'] == d['n_input_points'] and
               a['objective']['n_inference_output_points'] == d['n_target_points'],
               'the port decodes data.n_input_points points in training and data.n_target_points in eval')
        _check(a['model']['encoder']['n_neighbors'] == d['n_neighbors'],
               'the port builds the encoder graph over data.n_neighbors neighbours')
        _check(c['model']['class_name'] == 'DGCNN' and a['model']['decoder']['class_name'] == 'PCGen',
               'the port has the DGCNN classifier and the PCGen decoder')
        data = DataConfig(
            n_input_points=int(d['n_input_points']), n_target_points=int(d['n_target_points']),
            n_neighbors=int(d['n_neighbors']), n_classes=int(d['dataset']['n_classes']), translate=bool(d['translate']),
            rotate=bool(d['rotate']), jitter_sigma=float(d['jitter_sigma']), jitter_clip=float(d['jitter_clip']),
            resample=bool(d['resample']), dataset_name=str(d['dataset']['name']),
            dataset_settings=_freeze(dict(d['dataset'].get('settings') or {})))
        cm, ct = c['model'], _learn(c['train'])
        classifier = ClassifierConfig(
            name=str(cm['name']), n_neighbors=int(cm['n_neighbors']), conv_dims=_tuple(cm['conv_dims']),
            act_name=str(cm.get('act_name', '')), dropout_rates=tuple(float(r) for r in cm.get('dropout_rates') or ()),
            feature_dim=int(cm['feature_dim']), mlp_dims=_tuple(cm['mlp_dims']),
            train=ClassifierTrainConfig(
                momentum=float((c['train']['learn'].get('opt_settings') or {}).get('momentum', 0.0))
                if ct['optimizer_name'] == 'SGD' else 0.0, **ct))
        am, enc, dec, obj = a['model'], a['model']['encoder'], a['model']['decoder'], a['objective']
        autoencoder = AutoEncoderConfig(
            name=str(am['name']), class_name=str(am['class_name']), book_size=int(am['book_size']),
            embedding_dim=int(am['embedding_dim']), w_dim=int(am['w_dim']), vq_noise=float(am['vq_noise']),
            diagnose_every=int(a['diagnose_every']),
            encoder=EncoderConfig(class_name=str(enc['class_name']), conv_dims=_tuple(enc.get('conv_dims')),
                                  act_name=str(enc.get('act_name', ''))),
            decoder=DecoderConfig(sample_dim=int(dec['sample_dim']), n_components=int(dec['n_components']),
                                  map_dims=_tuple(dec['map_dims']), conv_dims=_tuple(dec['conv_dims']),
                                  tau=float(dec['tau']), act_name=str(dec.get('act_name', '')),
                                  filter=bool(dec['filter'])),
            train=AutoEncoderTrainConfig(recon_loss=str(obj['recon_loss']), c_embedding=float(obj['c_embedding']),
                                         **_learn(a['train'])))
        _check(autoencoder.w_dim % autoencoder.embedding_dim == 0, 'w_dim must be divisible by embedding_dim')
        wm = w['model']
        w_autoencoder = WAutoEncoderConfig(
            name=str(wm['name']), z1_dim=int(wm['z1_dim']), z2_dim=int(wm['z2_dim']),
            cf_temperature=float(wm['cf_temperature']), n_pseudo_inputs=int(wm['n_pseudo_inputs']),
            w_encoder=_net(wm['w_encoder']), w_decoder=_net(wm['w_decoder']),
            conditional_w_encoder=_net(wm['conditional_w_encoder']),
            train=WAutoEncoderTrainConfig(c_kld1=float(w['objective']['c_kld1']),
                                          c_kld2=float(w['objective']['c_kld2']), **_learn(w['train'])))
        g, t = u['generate'], u['trackers']
        user = UserConfig(
            counterfactual_value=float(u['counterfactual_value']),
            generate=GenerateConfig(batch_size=int(g['batch_size']), bias_dim=int(g['bias_dim']),
                                    bias_value=float(g['bias_value'])),
            seed=None if u['seed'] is None else int(u['seed']), cpu=bool(u['cpu']), n_workers=int(u['n_workers']),
            checkpoint_every=int(u['checkpoint_every']), load_checkpoint=int(u.get('load_checkpoint', -1)),
            trackers=TrackerConfig(**{k: bool(t[k]) for k in ('hydra', 'tensorboard', 'wandb', 'sqlalchemy', 'csv')}))
        return SliceConfig(data=data, classifier=classifier, autoencoder=autoencoder, w_autoencoder=w_autoencoder,
                           user=user, variation=str(tree['variation']), final=bool(tree['final']),
                           tags=tuple(tree.get('tags') or ()))


CONVOLUTIONAL_W_ENCODER = TransformerNetConfig(  # w_autoencoder/model/w_encoder/convolutional_w_encoder.yaml
    class_name='Convolutional', conv_dims=(16, 128, 256), mlp_dims=(), dropout_rates=(0.0,) * 3, act_name='')
LINEAR_W_DECODER = TransformerNetConfig(  # w_autoencoder/model/w_decoder/linear_w_decoder.yaml
    class_name='Linear', mlp_dims=(2048, 2048, 2048), dropout_rates=(0.0, 0.1, 0.3), act_name='')


# ---------------------------------------------------------------- from_tree


def _tuple(v) -> tuple:
    return tuple(v or ())


def _freeze(v: Any) -> Any:
    """A tree's dict as ``(key, value)`` pairs in its order and its lists as tuples."""
    if isinstance(v, dict):
        return tuple((k, _freeze(x)) for k, x in v.items())
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _scheduler(s: dict) -> SchedulerConfig:
    settings = dict(s.get('settings') or {})
    function = str(s['function'])
    allowed = {'Cosine': {'min_decay', 'decay_steps'}, 'Exponential': {'exp_decay'}, 'Constant': set()}
    _check(function in allowed, f'scheduler {function!r} is not one of {sorted(allowed)}')
    _check(set(settings) <= allowed[function], f'{function} scheduler settings {sorted(settings)} unknown')
    base = SchedulerConfig()
    return SchedulerConfig(restart_interval=int(s['restart_interval']), restart_fraction=float(s['restart_fraction']),
                           warmup_steps=int(s['warmup_steps']), function=function,
                           min_decay=float(settings.get('min_decay', base.min_decay)),
                           decay_steps=int(settings.get('decay_steps', base.decay_steps)),
                           exp_decay=float(settings.get('exp_decay', base.exp_decay)))


# the settings ``pccf/config/specs.py:69-91`` takes for each optimiser beside
# weight_decay: for Adam and RMSprop the keywords optax.adam and
# optax.rmsprop (0.2.6) take, which its lambdas pass on
OPT_SETTINGS = {
    'AdamW': set(),
    'SGD': {'momentum'},
    'Adam': {'b1', 'b2', 'eps', 'eps_root', 'mu_dtype', 'nesterov'},
    'RMSprop': {'decay', 'eps', 'initial_scale', 'eps_in_sqrt', 'centered', 'momentum', 'nesterov', 'bias_correction'},
}
# Adam's settings whose other values torch.optim.Adam does not compute
ADAM_FIXED = {'eps_root': 0.0, 'mu_dtype': None, 'nesterov': False}


def _learn(train: dict) -> dict:
    """The optimiser fields of ``<stage>.train`` shared by the three train configs."""
    learn = train['learn']
    opt = dict(learn.get('opt_settings') or {})
    name = str(learn['optimizer_name'])
    if name not in OPT_SETTINGS:
        raise ValueError(f'optimizer {name!r} is not one of {sorted(OPT_SETTINGS)} (pccf/config/specs.py)')
    extra = set(opt) - {'weight_decay'} - OPT_SETTINGS[name]
    _check(not extra, f'{name} takes no settings {sorted(extra)}')
    if name == 'Adam':
        for key, value in ADAM_FIXED.items():
            if opt.get(key, value) != value:
                raise NotImplementedError(f'Adam {key}={opt[key]!r} is not ported (pccf_torch runs Adam with {key}='
                                          f'{value!r})')
    settings = {k: v for k, v in opt.items() if k != 'weight_decay'} if name in ('Adam', 'RMSprop') else {}
    return dict(batch_size=int(train['batch_size']), n_epochs=int(train['n_epochs']), optimizer_name=name,
                learning_rate=float(learn['learning_rate']), weight_decay=float(opt.get('weight_decay', 0.0)),
                opt_settings=_freeze(settings), grad_op=learn['grad_op'], clip_criterion=str(learn['clip_criterion']),
                scheduler=_scheduler(learn['scheduler']), early_stopping=EarlyStoppingConfig(
                    active=bool(train['early_stopping']['active']), window=int(train['early_stopping']['window']),
                    patience=int(train['early_stopping']['patience'])))


def _net(n: dict) -> TransformerNetConfig:
    return TransformerNetConfig(proj_dim=int(n.get('proj_dim', 1)), n_heads=int(n.get('n_heads', 1)),
                                mlp_dims=_tuple(n.get('mlp_dims')), act_name=str(n.get('act_name', '')),
                                dropout_rates=tuple(float(r) for r in n.get('dropout_rates') or ()),
                                class_name=str(n['class_name']), conv_dims=_tuple(n.get('conv_dims')))

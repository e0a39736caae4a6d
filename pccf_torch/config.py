"""Flagship configuration of the port's slices, as plain dataclasses.

The JAX package composes its configuration from ``configs/experiment/**`` with
pydantic and pyyaml; the machine that runs the port has neither, so the
values the port needs are restated here, each field citing the yaml it comes
from.  ``tests/test_torch_port_modules.py`` holds these defaults against
``pccf.config.get_config_all([])`` so the two cannot drift apart.

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


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """autoencoder/train/learn/scheduler/cosine.yaml"""

    restart_interval: int = 100
    restart_fraction: float = 1.0
    warmup_steps: int = 0
    min_decay: float = 0.01
    decay_steps: int = 100


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
    grad_op: str | None = None  # train/learn/default_learn.yaml:7
    clip_criterion: str = 'ZStat'  # train/learn/default_learn.yaml:8
    # train/learn/scheduler/cosine.yaml: restart and decay over n_epochs, no warmup
    scheduler: SchedulerConfig = SchedulerConfig(restart_interval=CLASSIFIER_EPOCHS, min_decay=0.01,
                                                 decay_steps=CLASSIFIER_EPOCHS)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
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
    grad_op: str | None = 'ParamHistClipper'  # train/learn/default_learn.yaml:7
    clip_criterion: str = 'EMA'  # train/learn/default_learn.yaml:8
    # train/learn/scheduler/cosine.yaml: restart and decay over n_epochs, warmup 6
    scheduler: SchedulerConfig = SchedulerConfig(
        restart_interval=W_EPOCHS, warmup_steps=6, min_decay=0.01, decay_steps=W_EPOCHS)
    c_kld1: float = 0.1  # objective/vae_objective.yaml:1
    c_kld2: float = 4.0  # objective/vae_objective.yaml:2


@dataclasses.dataclass(frozen=True)
class WAutoEncoderConfig:
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
    grad_op: str | None = None  # autoencoder/train/learn/default_learn.yaml: none
    clip_criterion: str = 'ZStat'
    scheduler: SchedulerConfig = SchedulerConfig()
    # autoencoder/objective/{chamfer_emd,chamfer,chamfer_sinkhorn}.yaml; the
    # flagship composes chamfer_emd.yaml (autoencoder/autoencoder_exp.yaml:3)
    recon_loss: str = 'ChamferEMD'  # autoencoder/objective/chamfer_emd.yaml:2
    c_embedding: float = 8.0  # autoencoder/objective/chamfer_emd.yaml:3 (the same in the other two)


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
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
class UserConfig:
    # user/user_settings.yaml:21, how far the suites' counterfactuals move the
    # class probabilities towards the target (1: all the way)
    counterfactual_value: float = 1.0
    generate: GenerateConfig = GenerateConfig()  # user/user_settings.yaml:25


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


CONVOLUTIONAL_W_ENCODER = TransformerNetConfig(  # w_autoencoder/model/w_encoder/convolutional_w_encoder.yaml
    class_name='Convolutional', conv_dims=(16, 128, 256), mlp_dims=(), dropout_rates=(0.0,) * 3, act_name='')
LINEAR_W_DECODER = TransformerNetConfig(  # w_autoencoder/model/w_decoder/linear_w_decoder.yaml
    class_name='Linear', mlp_dims=(2048, 2048, 2048), dropout_rates=(0.0, 0.1, 0.3), act_name='')

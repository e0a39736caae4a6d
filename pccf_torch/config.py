"""Flagship configuration of the port's slices, as plain dataclasses.

The JAX package composes its configuration from ``configs/experiment/**`` with
pydantic and pyyaml; the machine that runs the port has neither, so the
values the port needs are restated here, each field citing the yaml it comes
from.  ``tests/test_torch_port_modules.py`` holds these defaults against
``pccf.config.get_config_all([])`` so the two cannot drift apart.

The slices cover the flagship unmodified: counterfactual serving with graph
filtering on, and the stage-1 VQ-VAE training step with the ChamferEMD loss.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n_input_points: int = 2048  # data/default_data.yaml:5
    n_target_points: int = 2048  # data/default_data.yaml:6
    n_neighbors: int = 25  # data/default_data.yaml:13
    n_classes: int = 2  # data/dataset/modelnet_desk_table.yaml:2


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    n_neighbors: int = 20  # classifier/model/dgcnn.yaml:3
    conv_dims: tuple[int, ...] = (64, 64, 128, 256)  # classifier/model/dgcnn.yaml:4
    act_name: str = ''  # classifier/model/dgcnn.yaml:5 (LeakyReLU 0.2)
    feature_dim: int = 512  # classifier/model/dgcnn.yaml:7
    mlp_dims: tuple[int, ...] = (512, 256)  # classifier/model/dgcnn.yaml:8


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # the DGCNN block widths are hard-coded in the reference (encoders.py:165),
    # not read from autoencoder/model/encoder/dgcnn.yaml's conv_dims
    h_dim: tuple[int, ...] = (64, 64, 128, 256)
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
    proj_dim: int = 512
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 1024)
    act_name: str = 'GELU'


@dataclasses.dataclass(frozen=True)
class WAutoEncoderConfig:
    z1_dim: int = 16  # w_autoencoder/model/wae.yaml:8
    z2_dim: int = 16  # w_autoencoder/model/wae.yaml:9
    cf_temperature: float = 5.0  # w_autoencoder/model/wae.yaml:10
    # w_autoencoder/model/w_encoder/transformer_w_encoder.yaml
    w_encoder: TransformerNetConfig = TransformerNetConfig()
    # w_autoencoder/model/w_decoder/transformer_w_decoder.yaml
    w_decoder: TransformerNetConfig = TransformerNetConfig(mlp_dims=(1024, 1024, 1024, 512))
    # w_autoencoder/model/conditional_w_encoder/transformer_conditional_w_encoder.yaml
    conditional_w_encoder: TransformerNetConfig = TransformerNetConfig()


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """autoencoder/train/learn/scheduler/cosine.yaml"""

    restart_interval: int = 100
    restart_fraction: float = 1.0
    warmup_steps: int = 0
    min_decay: float = 0.01
    decay_steps: int = 100


@dataclasses.dataclass(frozen=True)
class AutoEncoderTrainConfig:
    batch_size: int = 8  # autoencoder/train/default_train.yaml:6
    learning_rate: float = 0.004  # autoencoder/train/learn/default_learn.yaml:6
    weight_decay: float = 0.001  # autoencoder/train/learn/default_learn.yaml:10 (AdamW, :5)
    scheduler: SchedulerConfig = SchedulerConfig()
    c_embedding: float = 8.0  # autoencoder/objective/chamfer_emd.yaml:4 (recon_loss ChamferEMD, :3)


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    book_size: int = 16  # autoencoder/model/vqvae.yaml:8
    embedding_dim: int = 4  # autoencoder/model/vqvae.yaml:9
    w_dim: int = 1024  # autoencoder/model/vqvae.yaml:10
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    train: AutoEncoderTrainConfig = AutoEncoderTrainConfig()

    @property
    def n_codes(self) -> int:
        return self.w_dim // self.embedding_dim  # 256 code slots at flagship


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

"""The port's quality tools (the counterparts of ``tools/``), each run as
``python -m pccf_torch.tools.<name>``, on the card unless ``--cpu`` is given:

- :mod:`~pccf_torch.tools.quality_run`: the four stages on the 4-class
  synthetic surrogate at the flagship shapes, then the suites' counterfeit
  success, recorded as JSON;
- :mod:`~pccf_torch.tools.flip_probe`: the conditioning channel of a micro
  CVAE trained alone, and its counterfactual flip rate;
- :mod:`~pccf_torch.tools.cf_anatomy`: the counterfactual decode split by
  latent channel on a quality run's checkpoints;
- :mod:`~pccf_torch.tools.bn_ab`: the two BatchNorm semantics
  (``PCCF_BN_GROUPS``), an arm a subprocess;
- :mod:`~pccf_torch.tools.profile_train`: the pieces of a stage-1 step on
  the marginal timer (:func:`pccf_torch.utils.timing.marginal_time`).

What they share: the repository's root, the device flag, and the overrides
of the synthetic surrogate and of ``--smoke``'s tiny widths.
"""

from __future__ import annotations

import pathlib

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]

# the 4-class surrogate with per-instance variability at the flagship shapes
# (2048 points, k = 25, w_dim 1024): tools/quality_run.py's data overrides
SURROGATE = (
    'data/dataset=synthetic',
    'data.dataset.n_classes=4',
    'data.dataset.settings.base_points=4096',
)

# --smoke: tiny widths for a CPU-sized check of the plumbing (the model
# widths every tool's smoke shares, so a smoke run's checkpoints load in the
# others)
SMOKE_MODEL = (
    'data.dataset.settings.base_points=96',
    'data.n_input_points=64',
    'data.n_target_points=64',
    'data.n_neighbors=6',
    'classifier.model.n_neighbors=6',
    'classifier.model.conv_dims=[8,8]',
    'classifier.model.mlp_dims=[16,16]',
    'classifier.model.feature_dim=16',
    'autoencoder.model.w_dim=32',
    'autoencoder.model.embedding_dim=4',
    'autoencoder.model.book_size=4',
    'autoencoder.model.encoder.n_neighbors=6',
    'autoencoder.model.decoder.map_dims=[8]',
    'autoencoder.model.decoder.conv_dims=[16,8]',
    'autoencoder.model.decoder.n_components=2',
    'autoencoder.model.decoder.sample_dim=4',
)
SMOKE_W_MODEL = (
    'w_autoencoder.model.w_encoder.proj_dim=16',
    'w_autoencoder.model.w_encoder.n_heads=2',
    'w_autoencoder.model.w_encoder.mlp_dims=[16]',
    'w_autoencoder.model.w_decoder.proj_dim=16',
    'w_autoencoder.model.w_decoder.n_heads=2',
    'w_autoencoder.model.w_decoder.mlp_dims=[16]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=16',
    'w_autoencoder.model.conditional_w_encoder.n_heads=2',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[16]',
    'w_autoencoder.model.z1_dim=4',
    'w_autoencoder.model.z2_dim=4',
)


def device_of(cpu: bool) -> torch.device:
    """The CPU where asked, else the card; without a card this raises, and
    the tool does not go on on the CPU."""
    if cpu:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the tools run on the card unless --cpu is given')
    return torch.device('cuda')


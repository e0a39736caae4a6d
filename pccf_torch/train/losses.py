"""Stage-1 losses (``pccf/train/losses.py:46-75, 131-137, 307-312``)."""

from __future__ import annotations

import torch

from pccf_torch.config import AutoEncoderTrainConfig
from pccf_torch.data.structures import Outputs, Targets
from pccf_torch.kernels import api
from pccf_torch.train.objectives import Loss, Objective


def get_chamfer_emd_losses() -> tuple[Objective, Objective]:
    """Chamfer and EMD terms sharing one kernel launch: the second term finds
    the pair the first computed for the same ``(recon, ref_cloud)`` tensors."""
    cache: list = []

    def _pair(data: Outputs, targets: Targets) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = data.recon, targets.ref_cloud
        if len(cache) == 3 and cache[0] is a and cache[1] is b:
            return cache[2]
        out = api.chamfer_match_cost(a, b)
        cache[:] = [a, b, out]
        return out

    def _chamfer(data: Outputs, targets: Targets) -> torch.Tensor:
        return _pair(data, targets)[0]

    def _emd(data: Outputs, targets: Targets) -> torch.Tensor:
        return _pair(data, targets)[1]

    return Loss(_chamfer, 'Chamfer'), Loss(_emd, 'EMD')


def get_embed_loss() -> Objective:
    """MSE between the encoding and its quantisation, per sample."""

    def _embed(data: Outputs, _t: Targets) -> torch.Tensor:
        return torch.mean((data.w_q - data.w_e) ** 2, dim=1)

    return Loss(_embed, 'Embed. Loss')


def get_autoencoder_loss(cfg: AutoEncoderTrainConfig) -> Objective:
    """Chamfer + EMD + ``c_embedding`` · embedding loss (the ChamferEMD
    objective of ``configs/experiment/autoencoder/objective/chamfer_emd.yaml``)."""
    chamfer_term, emd_term = get_chamfer_emd_losses()
    return chamfer_term + emd_term + cfg.c_embedding * get_embed_loss()

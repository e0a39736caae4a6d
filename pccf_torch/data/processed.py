"""The derived dataset of stage 2 (``pccf/data/processed.py:45-146``).

The inner CVAE trains on what the frozen VQ-VAE and classifier make of the
point clouds: the encoder output ``w_q``, its quantisation ``w_e`` with the
one-hot selections, and the classifier's logits.  Both models run in eval
on their own device, in chunks of at most 64 clouds (``processed.py:27``),
every time a batch is fetched, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pccf_torch.data.structures import Inputs, WInputs, WTargets

MAX_BATCH = 64


class WDatasetWithLogits:
    """``(WInputs, WTargets)`` batches over a set of clouds ``(N, P, 3)``
    (``processed.py:98-124``).  The two models are frozen: this dataset
    puts them in eval mode and computes without gradients."""

    def __init__(self, clouds: torch.Tensor, vqvae: torch.nn.Module, classifier: torch.nn.Module) -> None:
        self.clouds = clouds
        self.vqvae, self.classifier = vqvae.eval(), classifier.eval()

    def __len__(self) -> int:
        return self.clouds.shape[0]

    @torch.no_grad()
    def __getitems__(self, idx_list: Sequence[int]) -> tuple[WInputs, WTargets]:
        device = self.vqvae.codebook.device
        idx = torch.as_tensor(idx_list, dtype=torch.long)
        parts = []
        for start in range(0, len(idx), MAX_BATCH):
            inputs = Inputs(cloud=self.clouds[idx[start: start + MAX_BATCH].to(self.clouds.device)].to(device))
            data = self.vqvae.encode_quantize(inputs)
            parts.append((data.w_q, data.w_e, data.one_hot_idx, self.classifier(inputs)))
        w_q, w_e, one_hot, logits = (torch.cat(p) for p in zip(*parts))
        return WInputs(w_q, logits), WTargets(w_e=w_e, one_hot_idx=one_hot, logits=logits)

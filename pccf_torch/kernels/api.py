"""Kernel dispatch by tensor device.

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version.  There is no environment switch
and no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import cvae, gather, knn as knn_mod, pcgen

# name -> the CUDA wrapper that counts its launches
KERNELS = {
    'knn': knn_mod.knn_cuda,
    'graph_max_pool': gather.graph_max_pool_cuda,
    'pcgen_mix': pcgen.pcgen_mix_cuda,
    'cvae_cf': cvae.cvae_cf_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError(f'no kernel or plain version for device {t.device}')


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices ``(B, N, k)`` int32, self included, distance-sorted."""
    return knn_mod.knn_cuda(x, k) if _on_cuda(x) else knn_mod.plain(x, k)


def graph_max_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over the k gathered neighbours, ``(B, N, F)``."""
    return gather.graph_max_pool_cuda(x, idx) if _on_cuda(x) else gather.plain(x, idx)


def pcgen_mix(m: torch.Tensor, w: torch.Tensor, pack: pcgen.PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    """PCGen map head + components + mix, ``(B, N, 3)``."""
    fn = pcgen.pcgen_mix_cuda if _on_cuda(m) else pcgen.plain
    return fn(m, w, pack, tau=tau, act_slope=act_slope)


def cvae_cf(x: torch.Tensor, probs: torch.Tensor, pack: cvae.CVAEPack) -> torch.Tensor:
    """The deterministic counterfactual CVAE chain, ``(B, T, e)``."""
    return cvae.cvae_cf_cuda(x, probs, pack) if _on_cuda(x) else cvae.plain(x, probs, pack)

"""Kernel dispatch by tensor device.

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version.  There is no environment switch
and no fallback: a kernel that fails to build or launch raises.  The
functions that training differentiates go through autograd functions whose
forward and backward dispatch the same way.
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, cvae, emd, gather, knn as knn_mod, ops, pcgen

# name -> the CUDA wrapper that counts its launches
KERNELS = {
    'knn': knn_mod.knn_cuda,
    'graph_max_pool': gather.graph_max_pool_cuda,
    'pcgen_mix': pcgen.pcgen_mix_cuda,
    'cvae_cf': cvae.cvae_cf_cuda,
    'gather_neighbors': gather.gather_neighbors_cuda,
    'scatter_add_rows': gather.scatter_add_rows_cuda,
    'graph_max_pool_src': gather.graph_max_pool_src_cuda,
    'scatter_add_slots': gather.scatter_add_slots_cuda,
    'graph_sum_pool': gather.graph_sum_pool_cuda,
    'chamfer_match_cost': emd.chamfer_match_cost_cuda,
}

FILTER_NEIGHBORS = 4  # graph filtering's k, self included (pccf/kernels/api.py:178)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices ``(B, N, k)`` int32, self included, distance-sorted."""
    x = x.detach()
    return knn_mod.knn_cuda(x, k) if _build.on_cuda(x) else knn_mod.plain(x, k)


def graph_max_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over the k gathered neighbours, ``(B, N, F)``.  With a gradient to
    compute it records each channel's winning slot and scatters the
    cotangent there; otherwise it runs the eval kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return gather.GraphMaxPool.apply(x, idx)
    return gather.graph_max_pool_cuda(x, idx) if _build.on_cuda(x) else gather.plain(x, idx)


def graph_sum_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sum over the k gathered neighbours, ``(B, N, C)``."""
    return gather.GraphSumPool.apply(x, idx)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour rows ``(B, N, k, C)``."""
    return gather.GatherNeighbors.apply(x, idx)


def graph_filtering(x: torch.Tensor, k: int = FILTER_NEIGHBORS) -> torch.Tensor:
    """PCGen output sharpening (``pccf/kernels/api.py:178-181``): kNN, then
    the gathered neighbours weighted by distance."""
    return ops.graph_filtering_with_idx(x, knn(x, k), gather_fn=gather_neighbors)


def chamfer_match_cost(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(chamfer (B,), emd (B,))`` of one cloud pair from one launch;
    Chamfer is the mean over the points of each direction."""
    return emd.ChamferMatchCost.apply(x, y)


def match_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ApproxMatch EMD ``(B,)``, the fused kernel with Chamfer off."""
    return emd.MatchCost.apply(x, y)


def pcgen_mix(m: torch.Tensor, w: torch.Tensor, pack: pcgen.PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    """PCGen map head + components + mix, ``(B, N, 3)``."""
    fn = pcgen.pcgen_mix_cuda if _build.on_cuda(m) else pcgen.plain
    return fn(m, w, pack, tau=tau, act_slope=act_slope)


def cvae_cf(x: torch.Tensor, probs: torch.Tensor, pack: cvae.CVAEPack) -> torch.Tensor:
    """The deterministic counterfactual CVAE chain, ``(B, T, e)``."""
    return cvae.cvae_cf_cuda(x, probs, pack) if _build.on_cuda(x) else cvae.plain(x, probs, pack)

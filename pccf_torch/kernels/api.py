"""Kernel dispatch by tensor device.

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version; any other device raises.  There
is no environment switch and no fallback: a kernel that fails to build or
launch raises.  The kernels the serving endpoints reach are ``torch.ops.pccf``
custom ops (:mod:`pccf_torch.kernels.library`), which PyTorch dispatches by
device and ``torch.export`` traces; the functions that only training
differentiates go through autograd functions whose forward and backward
dispatch the same way.
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import (_build, auction_emd as auction_mod, chamfer as chamfer_mod, cvae, emd, gather,
                                graph_filter, knn as knn_mod, library, ops, pcgen, sinkhorn, wformer)

# name -> the CUDA wrapper that counts its launches
KERNELS = {
    'knn': knn_mod.knn_cuda,
    'graph_max_pool': gather.graph_max_pool_cuda,
    'pcgen_mix': pcgen.pcgen_mix_cuda,
    'pcgen_general': pcgen.pcgen_general_cuda,
    'pcgen_mix_partial': pcgen.pcgen_mix_partial_cuda,  # a rank's share of the expert-parallel decode
    'pcgen_general_partial': pcgen.pcgen_general_partial_cuda,
    'cvae_cf': cvae.cvae_cf_cuda,
    'gather_neighbors': gather.gather_neighbors_cuda,
    'scatter_add_rows': gather.scatter_add_rows_cuda,
    'graph_max_pool_src': gather.graph_max_pool_src_cuda,
    'scatter_add_slots': gather.scatter_add_slots_cuda,
    'graph_sum_pool': gather.graph_sum_pool_cuda,
    'chamfer_match_cost': emd.chamfer_match_cost_cuda,
    'wformer_encoder': wformer.wformer_encoder_cuda,
    'wformer_decoder': wformer.wformer_decoder_cuda,
    'gemm_bf16w': wformer.gemm_bf16w_cuda,  # each bf16-weight GEMM of the stacks (the server's bf16 cast)
    'attention_wide': wformer.attention_wide_cuda,  # each attention of the stacks at heads past 128
    'nn_distance': chamfer_mod.nn_distance_cuda,
    'sinkhorn_cost': sinkhorn.sinkhorn_cost_cuda,
    'graph_filter': graph_filter.graph_filter_cuda,
    'graph_filter_backward': graph_filter.graph_filter_backward_cuda,
    'auction_emd': auction_mod.auction_emd_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices ``(B, N, k)`` int32, self included, distance-sorted."""
    _build.check_device(x)
    return library.knn(x.detach(), k)


def graph_max_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over the k gathered neighbours, ``(B, N, F)``.  With a gradient to
    compute it records each channel's winning slot and scatters the
    cotangent there; otherwise it runs the eval kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return gather.GraphMaxPool.apply(x, idx)
    _build.check_device(x)
    return library.graph_max_pool(x, idx)


def graph_sum_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sum over the k gathered neighbours, ``(B, N, C)``."""
    return gather.GraphSumPool.apply(x, idx)


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour rows ``(B, N, k, C)``, the public gather op
    (``pccf/kernels/api.py:168``); graph filtering no longer runs it."""
    return gather.GatherNeighbors.apply(x, idx)


def graph_filtering(x: torch.Tensor) -> torch.Tensor:
    """PCGen output sharpening (``pccf/kernels/api.py:178-181``): the k = 4
    neighbours, self included, and the three after slot 0 weighted by
    distance, as one fused pass forward and backward on the card (the
    ``graph_filter`` op and its gradient, ``graph_filter_backward``)."""
    _build.check_device(x)
    return library.graph_filter(x)[0]


def chamfer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Chamfer distance ``(B,)``: the mean over the points of each direction
    of the squared distance to the nearest point of the other cloud."""
    return chamfer_mod.Chamfer.apply(x, y)


def nn_distance(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Bidirectional nearest neighbours ``d1 (B, N), i1 (B, N) int32, d2
    (B, M), i2 (B, M) int32``, differentiable in the distances
    (``pccf/kernels/api.py:184-190``).  Where both point counts are
    multiples of 256 (the Pallas gate without its VMEM term) the kernel's
    autograd function runs (the kernel on the card, its plain version on the
    CPU); elsewhere the plain operations, on either device, as JAX runs
    XLA."""
    if x.shape[1] % 256 == 0 and y.shape[1] % 256 == 0:
        return chamfer_mod.NNDistance.apply(x, y)
    return ops.nn_distance(x, y)


def auction_emd(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005, iters: int = 50,
                k_active: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Auction EMD ``(dis (B, N), assignment (B, N) int32)``, differentiable
    in ``dis`` (:func:`pccf_torch.kernels.auction_emd.auction_emd`)."""
    return auction_mod.auction_emd(x1, x2, eps, iters, k_active)


def chamfer_match_cost(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(chamfer (B,), emd (B,))`` of one cloud pair from one launch;
    Chamfer is the mean over the points of each direction."""
    return emd.ChamferMatchCost.apply(x, y)


def match_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ApproxMatch EMD ``(B,)``, the fused kernel with Chamfer off."""
    return emd.MatchCost.apply(x, y)


def chamfer_sinkhorn_cost(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(chamfer (B,), sinkhorn (B,))`` of one cloud pair from one launch;
    Chamfer is the mean over the points of each direction."""
    return sinkhorn.ChamferSinkhornCost.apply(x, y)


def pcgen_mix(m: torch.Tensor, w: torch.Tensor, pack: pcgen.PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    """PCGen map head + components + mix, ``(B, N, 3)``: on the card the
    flagship's kernel where it covers the pack's shapes, else the general
    one (the ``pcgen_mix`` and ``pcgen_general`` ops; on the CPU both are
    the plain version)."""
    _build.check_device(m)
    op = library.pcgen_mix if pcgen.flagship(m.shape[-1], pack.dims(), pack.head_w.shape[0]) else library.pcgen_general
    tensors = library.pcgen_tensors(pack)
    with library.caller_pack(tensors, pack):
        return op(m, w, tensors, tau, act_slope)


def pcgen_partial(m: torch.Tensor, w: torch.Tensor, pack: pcgen.PCGenPack, *,
                  act_slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A share's partial mix logits ``(B, N, G_t)`` and head outputs
    ``(B, N, G_l, 3)`` (:meth:`~pccf_torch.kernels.pcgen.PCGenPack.share`):
    on the card the flagship's kernel in partial mode where it covers the
    share, else the general one's."""
    if not _build.on_cuda(m):
        fn = pcgen.plain_partial
    elif pcgen.flagship(m.shape[-1], pack.dims(), pack.head_w.shape[0], pack.n_logits()):
        fn = pcgen.pcgen_mix_partial_cuda
    else:
        fn = pcgen.pcgen_general_partial_cuda
    return fn(m, w, pack, act_slope=act_slope)


def cvae_cf(x: torch.Tensor, probs: torch.Tensor, pack: cvae.CVAEPack) -> torch.Tensor:
    """The deterministic counterfactual CVAE chain, ``(B, T, e)``."""
    _build.check_device(x)
    tensors, layers = library.cvae_tensors(pack)
    with library.caller_pack(tensors, pack):
        return library.cvae_cf(x, probs, tensors, layers, list(pack.heads), pack.bf16)


def wformer_encoder(x: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    """A pre-norm encoder stack in eval, ``(B, T, d)``."""
    _build.check_device(x)
    return library.wformer_encoder(x, library.stack_tensors(pack, library.ENCODER_KEYS), n_heads)


def wformer_decoder(x: torch.Tensor, memory: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    """A pre-norm decoder stack (self, cross on ``memory``, FF) in eval, ``(B, T, d)``."""
    _build.check_device(x)
    return library.wformer_decoder(x, memory, library.stack_tensors(pack, library.DECODER_KEYS), n_heads)

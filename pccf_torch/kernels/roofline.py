"""The least time an H100 SXM could take for each kernel's work.

Each ``*_work`` function counts, from the shapes of one call's inputs, the
operations the function needs and the bytes it must move (every input read
once, every output written once), and names the peak rate of the instruction
class the kernel issues.  :func:`bound_ms` turns that into the larger of the
two times, ``operations / peak`` and ``bytes / 3.35 TB/s``, and says which
sets it.  Only ``chip_smoke.py`` reads these; no kernel does.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

import dataclasses

import torch

FP32 = 67e12  # FP32 on the CUDA cores, FLOP/s
TF32 = 495e12  # TF32 mma on the tensor cores, FLOP/s (the 3xTF32 kernels issue three per product)
BF16 = 989e12  # bf16 mma on the tensor cores, FLOP/s
FP16 = BF16  # fp16 mma: the same dense peak
HBM = 3.35e12  # device memory, bytes/s
F32 = 4

# ApproxMatch EMD + Chamfer, operations per point pair: d2 once (3 sub, 3 mul,
# 2 add), nine levels x three passes of exp, two multiplies and an add, and
# one compare per direction for Chamfer's minima
EMD_OPS_PER_PAIR = 8 + 9 * 3 * 4 + 2
# bidirectional nearest neighbours, operations per pair: d2 once (3 sub,
# 3 mul, 2 add) and one compare per direction, 2C + 5 for C = 3 as the TPU
# kernel's cost estimate counts it (pallas_chamfer.py:96)
NN_OPS_PER_PAIR = 8 + 3
# Sinkhorn with Chamfer, operations per pair, the least the function needs
# rather than the sweeps the kernel makes: d2 once (8); the stabilised kernel
# K built once, its shift, scale and exp and the first row sum (4); the other
# 23 updates of u and v each a multiply and an add over K (46); the final
# pass's rsqrt and three multiplies for the plan weight w, the cost's
# multiply-add, the products w (x1 - x2) that both gradients share (3, the
# difference is d2's) and their row and column sums (3 + 3); one compare per
# direction for Chamfer's minima (2)
SINKHORN_OPS_PER_PAIR = 8 + 4 + 23 * 2 + (4 + 2 + 3 + 3 + 3) + 2


# auction EMD, operations per (bidder, item) pair of a bid: the squared
# distance (3 sub, 3 mul, 2 add) and the benefit's subtraction; the compares
# that keep the running best and second are not counted
AUCTION_OPS_PER_PAIR = 8 + 1


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float  # operations the function needs
    bytes: float  # inputs read once, outputs written once
    peak: float  # operations/s of the instruction class the kernel issues


def bound_ms(work: Work) -> tuple[float, str]:
    """``(least ms, 'operations' or 'bytes')`` for ``work``."""
    t_ops, t_bytes = work.ops / work.peak * 1e3, work.bytes / HBM * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------ neighbour kernels


KNN_FMA_MAX_C = 16  # kFmaMaxC of csrc/knn.cu: above it the distances run on the tensor cores


def knn_work(x: torch.Tensor, k: int) -> Work:
    """Every pair's distance as C multiply-adds; selection uncounted.  The
    class is the one ``pccf_knn`` issues at this C: fp32 FMA up to
    :data:`KNN_FMA_MAX_C` channels, above it 3xTF32 on the tensor cores, the
    product counted once as :func:`gemm_work` counts it.  The scratch (norms,
    partial lists) is intermediate: the bytes are the input and the output."""
    b, n, c = x.shape
    return Work(2.0 * b * n * n * c, _nbytes(x) + b * n * k * 4, TF32 if c > KNN_FMA_MAX_C else FP32)


# graph filtering's backward, operations a point: per neighbour the
# difference (3), its squared sum (5), the guarded sqrt (2), -dist / sigma and
# its exp (2), g . diff (5), its product with w and dist and the point's sum
# (3), dL/ddist (2), through the sqrt (2), dL/ddiff (6) and the neighbour's
# row (6); then the weights' sum (3), the point's own row (9) and the row
# scatter's adds (12)
FILTER_BACKWARD_OPS_PER_POINT = 3 * (3 + 5 + 2 + 2 + 5 + 3 + 2 + 2 + 6 + 6) + 3 + 9 + 12


def filter_work(x: torch.Tensor, backward: bool = False) -> Work:
    """Graph filtering of ``x (B, N, 3)``.  The forward: the k = 4 search's
    pairs counted as :func:`knn_work` counts them (C multiply-adds a pair,
    fp32; the tail's few operations a point uncounted), ``x`` read once, the
    output, the ``(B, N, 4)`` indices and the ``(B,)`` mean written once.  The
    backward: :data:`FILTER_BACKWARD_OPS_PER_POINT` a point, ``x``, the
    indices, the mean and ``g`` read once, ``dx`` written once (the rows it
    hands the row scatter are intermediate)."""
    b, n, c = x.shape
    saved = b * n * 4 * 4 + b * F32
    if backward:
        return Work(float(FILTER_BACKWARD_OPS_PER_POINT * b * n), 3 * _nbytes(x) + saved, FP32)
    return Work(2.0 * b * n * n * c, 2 * _nbytes(x) + saved, FP32)


def pool_work(x: torch.Tensor, idx: torch.Tensor, slots: bool = False) -> Work:
    """Max- or sum-pool over k gathered rows: one op per gathered element;
    ``slots`` adds the uint8 winning-slot output of the training forward."""
    b, n, c = x.shape
    k = idx.shape[-1]
    return Work(float(b * n * k * c), _nbytes(x, idx) + b * n * c * (F32 + (1 if slots else 0)), FP32)


def gather_work(x: torch.Tensor, idx: torch.Tensor) -> Work:
    b, n, c = x.shape
    return Work(0.0, _nbytes(x, idx) + idx.numel() * c * F32, FP32)


def scatter_rows_work(g: torch.Tensor, idx: torch.Tensor, n: int) -> Work:
    """``dx[idx[b, i, j]] += g[b, i]``: one add per scattered element."""
    b, m, c = g.shape
    return Work(float(idx.numel() * c), _nbytes(g, idx) + b * n * c * F32, FP32)


def scatter_slots_work(g: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor, n: int) -> Work:
    b, _, c = g.shape
    return Work(float(g.numel()), _nbytes(g, idx, slots) + b * n * c * F32, FP32)


def _nn_out_bytes(b: int, n: int, m: int) -> int:
    return (b * n + b * m) * (F32 + 4)  # d1, i1, d2, i2


def emd_work(x: torch.Tensor, y: torch.Tensor) -> Work:
    """Cost and both gradients of ApproxMatch EMD with Chamfer's minima and
    argmins of both directions."""
    b, n, _ = x.shape
    m = y.shape[1]
    out = b * F32 + _nbytes(x, y) + _nn_out_bytes(b, n, m)
    return Work(float(EMD_OPS_PER_PAIR * b * n * m), _nbytes(x, y) + out, FP32)


def nn_distance_work(x: torch.Tensor, y: torch.Tensor) -> Work:
    """Minima and argmins of both directions."""
    b, n, _ = x.shape
    m = y.shape[1]
    return Work(float(NN_OPS_PER_PAIR * b * n * m), _nbytes(x, y) + _nn_out_bytes(b, n, m), FP32)


def auction_work(x1: torch.Tensor, x2: torch.Tensor, bids: int) -> Work:
    """``bids`` bids (the bidders of every round summed over the clouds: what
    this run's data needed, from the kernel's counts), each over all ``M``
    items; the bytes are the clouds in and ``dis`` and the assignment out."""
    b, n, _ = x1.shape
    return Work(AUCTION_OPS_PER_PAIR * bids * x2.shape[1], _nbytes(x1, x2) + b * n * 8, FP32)


def sinkhorn_work(x: torch.Tensor, y: torch.Tensor) -> Work:
    """Cost and both plan-constant gradients of the Sinkhorn surrogate, with
    Chamfer's minima and argmins of both directions."""
    b, n, _ = x.shape
    m = y.shape[1]
    out = b * F32 + _nbytes(x, y) + _nn_out_bytes(b, n, m)
    return Work(float(SINKHORN_OPS_PER_PAIR * b * n * m), _nbytes(x, y) + out, FP32)


# ------------------------------------------------- matrix-product kernels


def pcgen_work(m: torch.Tensor, w: torch.Tensor, pack) -> Work:
    """Map head, G component stacks, heads and the attention mix per point,
    at the fp16 tensor-core peak the kernel's products issue; the component
    weights move as fp16, the rest as fp32."""
    b, n, dm = m.shape
    d0 = pack.map_w.shape[0]
    g = pack.head_w.shape[0]
    per_point = 2 * dm * d0 + sum(2 * g * lw.shape[1] * lw.shape[2] for lw in pack.layer_ws)
    per_point += 2 * pack.head_w.numel() + 2 * pack.att_w.numel()
    weights = 2 * sum(lw.numel() for lw in pack.layer_ws) + F32 * sum(
        t.numel() for t in (pack.map_w, pack.map_b, *pack.layer_bs, pack.head_w, pack.head_b, pack.att_w, pack.att_b))
    return Work(float(b * n * per_point), _nbytes(m, w) + weights + b * n * 3 * F32, FP16)


def pcgen_general_work(m: torch.Tensor, w: torch.Tensor, pack) -> Work:
    """:func:`pcgen_work` for ``csrc/pcgen_general.cu``: the same operations,
    at the TF32 peak its component products issue, every weight moved as
    fp32."""
    work = pcgen_work(m, w, pack)
    return Work(work.ops, work.bytes + 2 * sum(lw.numel() for lw in pack.layer_ws), TF32)


def pcgen_partial_work(m: torch.Tensor, w: torch.Tensor, pack, general: bool = False) -> Work:
    """A share's partial mode (:meth:`~pccf_torch.kernels.pcgen.PCGenPack.share`):
    :func:`pcgen_work` (or :func:`pcgen_general_work`) of its components,
    writing ``G_t`` logits and ``G_l`` heads a point in place of the mix."""
    work = (pcgen_general_work if general else pcgen_work)(m, w, pack)
    b, n = m.shape[:2]
    extra = b * n * (pack.att_w.shape[0] + 3 * pack.head_w.shape[0] - 3) * F32
    return Work(work.ops, work.bytes + extra, work.peak)


def gemm_work(m: int, n: int, k: int, groups: int = 1, bias: bool = True, res_rows: int = 0,
              weight_bytes: int = F32) -> Work:
    """One ``pccf_gemm`` launch: ``groups`` products ``(m, k) · (k, n)``, 2·m·n·k
    operations each as :func:`_stack_ops` counts them (the epilogue's adds
    and GELU uncounted); ``a``, the weights (``weight_bytes`` an element: 2
    for ``pccf_gemm_bf16w``), biases and ``res_rows`` rows of the residual
    read once, the outputs written once.  The peak is the class each
    instance issues: TF32 for fp32 weights, bf16 for ``pccf_gemm_bf16w``
    (its products are bf16 MMAs on the weights as stored)."""
    read = F32 * (m * k + groups * (n if bias else 0) + res_rows * n) + weight_bytes * groups * n * k
    return Work(2.0 * groups * m * n * k, read + F32 * groups * m * n, BF16 if weight_bytes == 2 else TF32)


def attention_work(b: int, t_q: int, t_k: int, n_heads: int, head_dim: int) -> Work:
    """One ``pccf_attention`` launch: scores and P·V, 4·t_q·t_k·d operations a
    sample as :func:`_stack_ops` counts them (softmax uncounted); q, k, v
    read once, the output written once."""
    d = n_heads * head_dim
    return Work(4.0 * b * t_q * t_k * d, F32 * 2 * b * (t_q + t_k) * d, TF32)


def split_work(weights: list[torch.Tensor]) -> Work:
    """One ``pccf_tf32_split`` launch over ``weights``: the big part's mask,
    the subtraction, the rounding add and its mask per element, on the CUDA
    cores; each weight read once, its small part written once."""
    n = sum(w.numel() for w in weights)
    return Work(4.0 * n, F32 * 2 * n, FP32)


def _stack_ops(b: int, t: int, t_mem: int, d: int, pack: list[dict], cross: bool) -> float:
    per_sample = 0.0
    for p in pack:
        f = p['w1'].shape[0]
        per_sample += 8 * t * d * d + 4 * t * t * d  # q, k, v, out projections; scores and P·V
        if cross:
            per_sample += 4 * t * d * d + 4 * t_mem * d * d + 4 * t * t_mem * d
        per_sample += 4 * t * d * f
    return b * per_sample


def _pack_bytes(pack: list[dict]) -> int:
    return sum(_nbytes(v) for p in pack for v in p.values())


def encoder_stack_work(x: torch.Tensor, pack: list[dict]) -> Work:
    b, t, d = x.shape
    return Work(_stack_ops(b, t, t, d, pack, False), 2 * _nbytes(x) + _pack_bytes(pack), TF32)


def decoder_stack_work(x: torch.Tensor, memory: torch.Tensor, pack: list[dict]) -> Work:
    b, t, d = x.shape
    return Work(_stack_ops(b, t, memory.shape[1], d, pack, True),
                2 * _nbytes(x) + _nbytes(memory) + _pack_bytes(pack), TF32)


def cvae_work(x: torch.Tensor, probs: torch.Tensor, pack) -> Work:
    """The chain: two input projections, two encoder stacks, the folded head
    products, the decoder stack and the compress head."""
    b, t, e = x.shape
    d = pack.aw.shape[0]
    mats = 2 * 2 * b * t * e * d + 2 * 2 * b * t * d * d + 2 * b * t * d * e
    ops = mats + _stack_ops(b, t, t, d, pack.enc1, False) + _stack_ops(b, t, t, d, pack.enc2, False)
    ops += _stack_ops(b, t, t, d, pack.dec, True)
    weights = _pack_bytes(pack.enc1) + _pack_bytes(pack.enc2) + _pack_bytes(pack.dec) + _nbytes(
        pack.win1, pack.add1, pack.aw, pack.ab, pack.win2, pack.add2, pack.bw, pack.addd, pack.wcomp, pack.bcomp,
        pack.prior_z2p, pack.wp, pack.bp)
    return Work(float(ops), 2 * _nbytes(x) + _nbytes(probs) + weights, TF32)

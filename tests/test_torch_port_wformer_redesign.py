"""The arithmetic and the plans of the stacks' bf16-weight GEMM and wide
attention (``csrc/wformer.cu``: ``gemm_bf16w_kernel``,
``attention_wide_kernel``), rehearsed in plain PyTorch on the CPU.

The kernels run only on the card (``tests/test_torch_port_cuda.py`` holds
them to float64 there); these hold the arithmetic they are built on to the
same tolerances, and the index maps they read shared memory with to the
128-byte swizzle TMA writes.  No JAX.

Tolerances: the three bf16 parts of an fp32 value sum back to it within
2^-24 of its magnitude (each residual is exact); three bf16 products a
32-wide k tile, summed in fp32, within the card's GEMM_REL_L2 (5e-6) of the
float64 product; the wide attention's score tiles with the softmax running on
across them, in fp32, within ATTENTION_REL_L2 (1e-5) of the exact softmax in
float64.
"""

import numpy as np
import pytest
import torch

from pccf_torch.kernels import wformer

torch.set_num_threads(1)

GEMM_REL_L2 = 5e-6
ATTENTION_REL_L2 = 1e-5


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel_l2(a, b):
    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def bf16x3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``split_bf16x3``: a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 -
    a2), each rounded to nearest even, widened back to fp32."""
    a1 = a.bfloat16().float()
    a2 = (a - a1).bfloat16().float()
    a3 = (a - a1 - a2).bfloat16().float()
    return a1, a2, a3


def swizzled(r: int, c: int) -> int:
    """The float of element (r, c) of a tile of 32-float rows as TMA writes
    it with the 128-byte swizzle (``csrc/hopper.cuh``)."""
    return r * 32 + (((c // 4) ^ (r % 8)) * 4) + c % 4


@pytest.mark.parametrize('scale', [1.0, 1e-20, 1e30])
def test_bf16x3_parts_sum_back(scale):
    """Each part holds 8 significant bits, each residual is exact in fp32:
    the three parts sum back to the value, here within 2^-24 of it (far from
    fp32's subnormals, where the last part would lose bits)."""
    a = _randn((4096,), 1) * scale
    a1, a2, a3 = bf16x3(a)
    for part in (a1, a2, a3):
        assert torch.equal(part, part.bfloat16().float())
    err = (a1.double() + a2.double() + a3.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -24 * a.double().abs()).all())


def test_bf16x3_products_match_float64():
    """Three bf16 products of the activation's parts with the bf16 weights,
    each 32-wide k tile summed in fp32 into a fresh partial sum (smallest part
    first) and the tiles added in fp32, as ``gemm_bf16w_kernel`` sums them,
    against float64 on the widened weights at (256, 512, 512)."""
    m, n, k = 256, 512, 512
    a, w = _randn((m, k), 2), (_randn((n, k), 3) * k ** -0.5).bfloat16().float()
    parts = bf16x3(a)
    acc = torch.zeros(m, n)
    for k0 in range(0, k, 32):
        wt = w[:, k0: k0 + 32].T
        part = torch.zeros(m, n)
        for p in reversed(parts):
            part = part + p[:, k0: k0 + 32] @ wt  # each product exact; sums in fp32
        acc = acc + part
    assert _rel_l2(acc, a.double() @ w.double().T) <= GEMM_REL_L2


def wide_attention_rehearsal(q, k, v, heads, keys=wformer.WIDE_KEYS):
    """The wide attention's arithmetic in fp32: per score tile of ``keys``
    keys the raw scores, the tile's max, p = exp((s - max) * scale), the row
    sums, P·V; across tiles the running max and sum and the stored output
    combined as out * l_old * corr / l_new + O / l_new."""
    b, t_q, d = q.shape
    hd = d // heads
    scale = 1.0 / hd ** 0.5

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    out = torch.zeros_like(qh)
    m_run = torch.full(qh.shape[:-1], -float('inf'))
    l_run = torch.zeros(qh.shape[:-1])
    for k0 in range(0, k.shape[1], keys):
        s = qh @ kh[:, :, k0: k0 + keys].transpose(-1, -2)
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp((m_run - m_new) * scale)
        p = torch.exp((s - m_new[..., None]) * scale)
        l_new = l_run * corr + p.sum(-1)
        o = p @ vh[:, :, k0: k0 + keys]
        out = out * (l_run * corr / l_new)[..., None] + o / l_new[..., None]
        m_run, l_run = m_new, l_new
    return out.transpose(1, 2).reshape(b, t_q, d)


@pytest.mark.parametrize('t_k', [256, 384, 640])
@pytest.mark.parametrize('heads,hd', [(1, 512), (2, 256), (2, 136)])
def test_wide_attention_score_tiles_match_float64(heads, hd, t_k):
    """One score tile (256 keys: an exact softmax) and two or three (the
    softmax running on across them) against the exact softmax in float64."""
    b, t_q, d = 2, 64, heads * hd
    q, k, v = _randn((b, t_q, d), 4), _randn((b, t_k, d), 5), _randn((b, t_k, d), 6)
    got = wide_attention_rehearsal(q, k, v, heads)

    def split(x):
        return x.double().reshape(b, -1, heads, hd).transpose(1, 2)

    w = torch.softmax(split(q) @ split(k).transpose(-1, -2) / hd ** 0.5, dim=-1)
    want = (w @ split(v)).transpose(1, 2).reshape(b, t_q, d)
    assert _rel_l2(got, want) <= ATTENTION_REL_L2


def test_bf16_fragments_read_the_swizzled_tile():
    """``a_fragments_bf16x3``: lane (g, t) of warp rows wr reads, for k step
    s and register i, the float2 at r * 32 + ((4s + t / 2 + 2 (i / 2)) ^ g) * 4
    + 2 (t % 2) with r = wr + g + 8 (i % 2); that is the swizzled place of
    row r, columns 16s + 2t + 8 (i / 2) and the next, wgmma's bf16 A
    fragment (registers 0-3: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8,
    2t + 8)), and the 32 lanes of a warp cover its 16 x 32 slice once."""
    for wr in (0, 16, 32, 48):
        seen = set()
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for step in range(2):
                for i in range(4):
                    r = wr + g + 8 * (i & 1)
                    chunk = 4 * step + (t >> 1) + 2 * (i >> 1)
                    at = r * 32 + ((chunk ^ g) << 2) + 2 * (t & 1)
                    col = 16 * step + 2 * t + 8 * (i >> 1)
                    assert at == swizzled(r, col) and at + 1 == swizzled(r, col + 1)
                    seen.update({(r, col), (r, col + 1)})
        assert seen == {(r, c) for r in range(wr, wr + 16) for c in range(32)}


def wide_p_column(key: int) -> int:
    """``wide_p_column``: within each 8 keys, key 2j at slot j, 2j + 1 at j + 4."""
    return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1)


def test_wide_attention_index_maps():
    """The wide kernel's own index maps against the swizzle: the Q split
    pass's float4 e holds row e / 8 at logical columns 4 ((e % 8) ^ (row %
    8)) onward; P's key order is a permutation within each 8 keys, and a P
    entry (query q, key) lies in box key / 32 at q's row, each of a 64 x 256
    tile's entries at its own place; V^T's fragments (k slot t and t + 4 of
    a step: keys 2t and 2t + 1, the keys P's slots t and t + 4 hold) read
    32 distinct banks in each load of a warp."""
    for e in range(512):
        r, c4 = e >> 3, ((e & 7) ^ ((e >> 3) & 7)) << 2
        assert swizzled(r, c4) == 4 * e
    for k0 in range(0, 256, 8):
        assert sorted(wide_p_column(k) for k in range(k0, k0 + 8)) == list(range(k0, k0 + 8))
        for t in range(4):
            assert wide_p_column(k0 + 2 * t) == k0 + t and wide_p_column(k0 + 2 * t + 1) == k0 + t + 4
    places = set()
    for q in range(64):
        for key in range(256):
            kp = wide_p_column(key)
            places.add((kp >> 5) * 2048 + q * 32 + ((((kp & 31) >> 2) ^ (q & 7)) << 2) + (kp & 3))
    assert places == {(kp >> 5) * 2048 + swizzled(q, kp & 31) for q in range(64) for kp in range(256)}
    for wr in (0, 16, 32, 48):
        for kk in range(8):
            for dc, dr in ((0, 0), (8, 0), (0, 1), (8, 1)):  # a0, a1, a2, a3
                banks = set()
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    c, r = (wr & 31) + g + dc, 8 * kk + 2 * t + dr
                    banks.add(swizzled(r, c) % 32)
                assert len(banks) == 32


def test_wide_plan_fits_every_head_the_gate_admits():
    """Every head past 128 wide at d <= 1024 that the stacks' gate admits
    (``wformer.supported``), at any key count in 64s to 1024, fits the
    card's shared memory, with score and output chunks covering the head."""
    for d in range(128, 1025, 128):
        for heads in range(1, d + 1):
            if not wformer.supported(128, d, heads) or d // heads <= wformer.WIDE_HEAD:
                continue
            hd = d // heads
            for t_k in range(64, 1025, 64):
                plan = wformer.wide_plan(t_k, hd)
                assert plan.smem <= wformer.MAX_SMEM
                assert plan.score_chunks * 32 >= hd > (plan.score_chunks - 1) * 32
                assert plan.out_chunks * 128 >= hd and plan.score_tiles * 256 >= t_k
    with pytest.raises(ValueError):
        wformer.wide_plan(256, 128)


@pytest.mark.parametrize('bf16', [False, True])
def test_gemm_plan_fits(bf16):
    """Every tile the GEMM takes fits the card's shared memory, the bf16 ring
    twice as deep as the fp32 one."""
    for m in (64, 128, 4096, 8192):
        for n in (64, 512, 1024):
            for groups in (1, 3):
                plan = wformer.gemm_plan(m, n, groups, bf16)
                assert plan.smem <= wformer.MAX_SMEM
                assert plan.stages == (8 if bf16 else 4)

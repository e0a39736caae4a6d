"""Pre-norm transformer stacks: weight pack, plain versions, and the CUDA
stack launchers over ``csrc/wformer.cu``.

Replaces ``pccf/kernels/pallas_wformer.py:335`` ``wformer_encoder_tpu`` and
``:365`` ``wformer_decoder_tpu``, which run a whole encoder or decoder stack of
the W-autoencoder's transformer nets in one ``pallas_call`` with every
layer's weights and the residual stream resident in VMEM.  A block on the
card has 227 KB of shared memory, so here a stack is a sequence of launches
of three kernels (GEMM with a bias / exact-GELU / residual epilogue,
LayerNorm, attention), layer by layer, on one stream: 7 launches an encoder
layer and 12 a decoder layer, the q, k and v projections of one LayerNorm
output (and the cross-attention's k and v of ``memory``) one grouped GEMM
launch.  The residual stream stays in one device buffer that the GEMM
epilogues update in place.  The products run as 3xTF32 (about fp32
rounding): the stacks feed the VQ argmin and the quantisation accuracy,
which bf16 products flip against the fp32 reference.  The GEMM reads each
weight's TF32 small part from a tensor that :class:`Stacks` makes with one
launch before a stack's first layer (:func:`split_small`).  The CVAE chain
(:mod:`pccf_torch.kernels.cvae`) runs its three stacks through the same
launchers.

The pack is a list of per-layer dicts of the live module weights, each in
its ``nn.Linear``'s own ``(out, in)`` layout: detached views, no copies, so
packing on every eval call costs nothing and no pack outlives a training
step.  A server's bf16 cast (:func:`pccf_torch.serve.bf16_copy`) stores the
weights in bfloat16 behind a widening parametrisation: the pack then holds
the stored bf16 matrices (:func:`stored`), and the GEMM reads them through
its bf16-weight instance (``pccf_gemm_bf16w``, ``gemm_bf16w_kernel``: the
bf16 weight tile goes to the tensor cores as TMA loads it, a quarter of the
bytes of an fp32 weight and its small part, and the fp32 activation as three
bf16 parts, six bf16 products a 32-wide k tile where the fp32 instance
issues twelve TF32 ones), while LayerNorm parameters and biases are widened
to fp32.  Heads past 128 wide run the attention's wide instance
(``attention_wide_kernel``, :func:`attention_wide_cuda`: each score of a
head computed once, on wgmma).
Differing FF widths need no padding: each layer's GEMMs take its own
width.  The GEMM takes widths in multiples of 64; a layer whose FF width is
not one packs a zero-padded copy of its FF weights instead (zero rows of the
first, zero bias, zero columns of the second: the exact GELU of 0 is 0, so
the result is exact), made once and kept on the layer until its parameters
change.  The stacks are eval only: no dropout and no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.nn.utils import parametrize

from pccf_torch.kernels import _build, ops

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (pallas_wformer.py:38)
TF32_BIG = -(1 << 13)  # int32 mask keeping the sign, exponent and 10 mantissa bits a tensor core reads
FF_MULTIPLE = 64  # pccf_gemm: N % 64 and K % 32; other FF widths are padded in the pack
WIDE_HEAD = 128  # heads wider than this run pccf_attention's wide instance
MAX_SMEM = 232_448  # dynamic shared memory a block may take on an H100


def supported(t: int, d: int, n_heads: int) -> bool:
    """The shape line of the JAX package's fused stacks
    (``pallas_wformer.py:41-49`` ``wformer_supported``): tokens and width in
    multiples of 128, whole heads.  Its VMEM budget is a TPU limit and is not
    carried over.  Inside it the card's kernels cover every net, heads of
    any width included (past :data:`WIDE_HEAD` wide, ``pccf_attention`` runs
    its wide instance, ``attention_wide_kernel``)."""
    return t % 128 == 0 and d % 128 == 0 and n_heads > 0 and d % n_heads == 0


# ------------------------------------------------------------------ pack


def stored(module: torch.nn.Module, name: str) -> torch.Tensor:
    """The tensor ``module`` stores under ``name``: under a parametrisation
    (the server's bf16 cast) the stored original, not the widened value
    ``getattr`` computes."""
    if parametrize.is_parametrized(module, name):
        return getattr(module.parametrizations, name).original.detach()
    return getattr(module, name).detach()


def _linears(prefix: str, linears: dict[str, torch.nn.Linear]) -> dict:
    """``w{prefix}{name}`` ``(out, in)`` and ``b{prefix}{name}`` of each
    Linear, as the GEMM kernel reads them: the weight as stored (fp32, or
    bf16 under the server's cast), the bias fp32."""
    out = {}
    for name, linear in linears.items():
        out[f'w{prefix}{name}'] = stored(linear, 'weight').contiguous()
        out[f'b{prefix}{name}'] = linear.bias.detach().float()
    return out


def _attn(attn, prefix: str = '') -> dict:
    return _linears(prefix, {'q': attn.query, 'k': attn.key, 'v': attn.value, 'o': attn.out})


def _ln(norm, name: str) -> dict:
    return {f'{name}_w': norm.weight.detach().float(), f'{name}_b': norm.bias.detach().float()}


def _feed_forward(layer) -> dict:
    """The FF weights of a layer as the GEMM reads them: the live weights
    where the width is a multiple of :data:`FF_MULTIPLE`, else a zero-padded
    copy (in the stored type) kept on the layer while its stored parameters
    keep their storage and version."""
    d0, d1 = layer.dense_0, layer.dense_1
    f = d0.out_features
    if f % FF_MULTIPLE == 0:
        return _linears('', {'1': d0, '2': d1})
    params = [stored(m, n) for m in (d0, d1) for n in ('weight', 'bias')]
    key = tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(layer, '_ff_padded', None)
    if cached is None or cached[0] != key:
        w0, b0, w1_, b1_ = params
        width = -(-f // FF_MULTIPLE) * FF_MULTIPLE
        w1 = w0.new_zeros(width, d0.in_features)
        b1 = torch.zeros(width, dtype=torch.float32, device=b0.device)
        w2 = w1_.new_zeros(d1.out_features, width)
        with torch.no_grad():
            w1[:f] = w0
            b1[:f] = b0
            w2[:, :f] = w1_
        cached = layer._ff_padded = (key, {'w1': w1, 'b1': b1, 'w2': w2, 'b2': b1_.float()})
    return dict(cached[1])


def pack_encoder_layer(layer) -> dict:
    return {**_ln(layer.norm_0, 'ln1'), **_attn(layer.attn_0), **_ln(layer.norm_1, 'ln2'), **_feed_forward(layer)}


def pack_decoder_layer(layer) -> dict:
    return {**_ln(layer.norm_0, 'ln1'), **_attn(layer.attn_0), **_ln(layer.norm_1, 'lnx'),
            **_attn(layer.attn_1, 'x'), **_ln(layer.norm_2, 'ln2'), **_feed_forward(layer)}


def pack_encoder(layers) -> list[dict]:
    return [pack_encoder_layer(layer) for layer in layers]


def pack_decoder(layers) -> list[dict]:
    return [pack_decoder_layer(layer) for layer in layers]


# --------------------------------------------------------- plain versions


def plain_encoder(x: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    """The encoder stack in plain PyTorch, float32: what the CPU runs and
    what ``chip_smoke.py`` holds the kernel against."""
    for p in pack:
        x = ops.encoder_layer(x, p, n_heads)
    return x


def plain_decoder(x: torch.Tensor, memory: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    for p in pack:
        x = ops.decoder_layer(x, memory, p, n_heads)
    return x


# --------------------------------------------------- 3xTF32 weight split


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` with ``w = big + small`` to about 2^-22 relative, as
    the GEMM kernel multiplies them: ``big`` is ``w`` truncated to TF32 (what
    the tensor cores read from a fp32 word) and ``small`` the remainder
    rounded to the nearest TF32, ties away from zero (``cvt.rna.tf32.f32``).
    The plain version of ``pccf_tf32_split``, which stores ``small``."""
    w = w.contiguous()
    big = (w.view(torch.int32) & TF32_BIG).view(torch.float32)
    small = (((w - big).view(torch.int32) + (1 << 12)) & TF32_BIG).view(torch.float32)
    return big, small


def stack_weights(pack: list[dict]) -> list[torch.Tensor]:
    """The matrices of a stack's pack, the GEMM's ``wt`` operands."""
    return [v for p in pack for name, v in p.items() if name.startswith('w')]


def gemm_plain(a: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor | None = None, res: torch.Tensor | None = None,
               gelu: bool = False) -> torch.Tensor:
    """What one group of ``pccf_gemm`` / ``pccf_gemm_bf16w`` computes, in
    ``a``'s type (float32; float64 for a reference): ``a · wtᵀ + bias [GELU]
    + res[row % rows(res)]``, a bf16 ``wt`` widened exactly."""
    out = torch.nn.functional.linear(a, wt.to(a.dtype), bias)
    if gelu:
        out = ops.gelu_exact(out)
    if res is not None:
        out = out + res.repeat(a.shape[0] // res.shape[0], 1)
    return out


# ------------------------------------------------------------------ plans
# the constants of csrc/wformer.cu the plans below are made of

GEMM_BK, GEMM_STAGES, BF16_STAGES = 32, 4, 8  # kBk, kStages, kBf16Stages
WIDE_KEYS, WIDE_CHUNK, WIDE_OUT, WIDE_QUERIES = 256, 32, 128, 64  # kWideKeys, kBk, kWideOut, kQt


class GemmPlan(NamedTuple):
    warpgroups: int  # 64 rows of the tile each
    columns: int
    stages: int
    smem: int  # dynamic shared memory, bytes


class WidePlan(NamedTuple):
    score_tiles: int  # of up to WIDE_KEYS keys
    score_chunks: int  # WIDE_CHUNK head columns each
    out_chunks: int  # WIDE_OUT head columns each
    smem: int


def gemm_plan(m: int, n: int, groups: int, bf16: bool) -> GemmPlan:
    """The tile ``pccf_gemm`` and ``pccf_gemm_bf16w`` take at ``(m, n)``:
    128x128 where that gives the 132 SMs a full wave, else 128x64, else
    64x64; and its ring: a stage holds A's 32-wide k slice and the weight's
    (fp32 and its small part; or bf16), plus the 1024-byte alignment and
    two mbarriers a stage (``pccf_gemm_plan`` mirrored)."""
    row_tiles = groups * (m // 128)
    wg, bn = 1, 64
    if m % 128 == 0 and n % 128 == 0 and row_tiles * (n // 128) >= 132:
        wg, bn = 2, 128
    elif m % 128 == 0 and row_tiles * (n // 64) >= 132:
        wg = 2
    stages = BF16_STAGES if bf16 else GEMM_STAGES
    stage = 64 * wg * GEMM_BK * 4 + bn * GEMM_BK * (2 if bf16 else 8)
    return GemmPlan(wg, bn, stages, stages * stage + 1024 + 2 * stages * 8)


def wide_plan(t_k: int, head_dim: int) -> WidePlan:
    """The wide attention's plan for ``t_k`` keys and heads of ``head_dim``
    (past :data:`WIDE_HEAD`): score tiles of up to :data:`WIDE_KEYS` keys,
    the head's columns in score chunks of 32 and output chunks of 128 (for a
    head that starts on 16 bytes; a head of a width off 4 may start up to 3
    columns into its first chunk and take one more), and shared memory that
    does not depend on the shape: P and its small part (64 queries x 256
    keys, twice; the two score stages of Q, its small part and 256 keys of K
    lie inside it), two V stages of 64 keys x 128 columns, the warps'
    partial maxima and sums, the running max and sum of two score tiles, 1 /
    sum and the stored output's factor, eleven mbarriers and the 1024-byte
    alignment (``pccf_attention_wide_plan`` mirrored)."""
    if head_dim <= WIDE_HEAD or t_k <= 0 or t_k % 64:
        raise ValueError(f'the wide attention takes heads past {WIDE_HEAD} and keys in 64s, got {head_dim}, {t_k}')
    box = 64 * WIDE_CHUNK * 4
    p_bytes = 2 * (WIDE_KEYS // 32) * box
    assert 2 * (2 + WIDE_KEYS // 64) * box <= p_bytes  # the score ring inside P's bytes
    v_bytes = 2 * (WIDE_OUT // WIDE_CHUNK) * box
    smem = p_bytes + v_bytes + 2 * 8 * WIDE_QUERIES * 4 + 3 * 2 * WIDE_QUERIES * 4 + 11 * 8 + 1024
    return WidePlan(-(-t_k // WIDE_KEYS), -(-head_dim // WIDE_CHUNK), -(-head_dim // WIDE_OUT), smem)


def kernel_gemm_plan(m: int, n: int, groups: int, bf16: bool) -> GemmPlan:
    """The GEMM plan the kernel library takes, to hold :func:`gemm_plan` to it."""
    out = (ctypes.c_int * 4)()
    _build.check('pccf_gemm_plan', _build.lib().pccf_gemm_plan(m, n, groups, int(bf16), out), f'({m}, {n}) x {groups}')
    return GemmPlan(*out)


def kernel_wide_plan(t_k: int, head_dim: int) -> WidePlan:
    """The wide attention's plan the kernel library takes, to hold
    :func:`wide_plan` to it."""
    out = (ctypes.c_int * 4)()
    _build.check('pccf_attention_wide_plan', _build.lib().pccf_attention_wide_plan(t_k, head_dim, out),
                 f't_k={t_k}, heads of {head_dim}')
    return WidePlan(*out)


def split_small(weights: list[torch.Tensor]) -> dict[int, torch.Tensor]:
    """The TF32 small part of each weight by one ``pccf_tf32_split`` launch,
    keyed by the weight's ``data_ptr``: views into one buffer, each starting
    on a 256-byte boundary (TMA reads 16-byte aligned rows)."""
    starts, total = [], 0
    for w in weights:
        starts.append(total)
        total += -(-w.numel() // 64) * 64
    buf = torch.empty(total, dtype=torch.float32, device=weights[0].device)
    smalls = [buf[s: s + w.numel()].view(w.shape) for s, w in zip(starts, weights)]
    n = len(weights)
    err = _build.lib().pccf_tf32_split(_pointers(weights), _pointers(smalls),
                                       (ctypes.c_longlong * n)(*(w.numel() for w in weights)), n, _build.stream())
    _build.check('pccf_tf32_split', err, f'{n} tensors')
    return {w.data_ptr(): s for w, s in zip(weights, smalls)}


def _pointers(tensors: list) -> ctypes.Array:
    """A host array of device pointers, null for ``None``."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() if t is not None else None for t in tensors))


# ------------------------------------------------------------ CUDA stacks


class Stacks:
    """Launches the entry points of ``csrc/wformer.cu`` for ``b`` sequences of
    ``t`` tokens of width ``d`` on the current stream, with scratch buffers
    allocated once per call.  The residual stream ``res (b * t, d)`` is
    updated in place: every residual add is a GEMM epilogue.

    The GEMM reads each weight's TF32 small part, which ``Stacks`` splits
    (:meth:`split`) the first time it meets the weight and keeps for its own
    lifetime, one call: a stack's weights in one launch before its first
    layer.  ``small`` gives parts split beforehand, keyed by the weight's
    ``data_ptr``, for weights that are a snapshot and cannot change (the CVAE
    pack's)."""

    def __init__(self, b: int, t: int, d: int, device: torch.device,
                 small: dict[int, torch.Tensor] | None = None) -> None:
        self.lib, self.stream = _build.lib(), _build.stream()
        self.b, self.t, self.d, self.m = b, t, d, b * t
        self.device = device
        self.small = dict(small or {})
        self._scratch: dict[str, torch.Tensor] = {}

    def split(self, weights: list[torch.Tensor]) -> None:
        """Split the TF32 small parts of the fp32 weights not split yet, in
        one launch; a bf16 weight has none."""
        new = {w.data_ptr(): w for w in weights if w.dtype == torch.float32 and w.data_ptr() not in self.small}
        if new:
            self.small.update(split_small(list(new.values())))

    def empty(self, *shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def scratch(self, name: str, rows: int, cols: int) -> torch.Tensor:
        buf = self._scratch.get(name)
        if buf is None or buf.numel() < rows * cols:
            buf = self._scratch[name] = self.empty(rows * cols)
        return buf[: rows * cols].view(rows, cols)

    def gemm(self, a, wts: list, biases: list, outs: list, res=None, res_rows: int = 0, gelu: bool = False) -> None:
        """``outs[g] = a · wts[g]ᵀ + biases[g] [GELU] + res[row % res_rows]``
        for every group ``g`` (at most 3, all ``(N, K)``) in one launch."""
        n, k = wts[0].shape
        m, groups = a.shape[0], len(wts)
        if any(tuple(w.shape) != (n, k) or w.dtype != wts[0].dtype for w in wts):
            raise ValueError(f'pccf_gemm: the grouped weights differ in shape or type: '
                             f'{[(tuple(w.shape), w.dtype) for w in wts]}')
        if wts[0].dtype == torch.bfloat16:
            gemm_bf16w_cuda(self, a, wts, biases, outs, res, res_rows, gelu)
            return
        if wts[0].dtype != torch.float32:
            raise ValueError(f'pccf_gemm: weights must be float32 or bfloat16, got {wts[0].dtype}')
        self.split(wts)
        ops = _pointers([*wts, *(self.small[w.data_ptr()] for w in wts), *biases, *outs])
        err = self.lib.pccf_gemm(a.data_ptr(), groups, ops, res.data_ptr() if res is not None else None,
                                 m, n, k, res_rows or m, int(gelu), self.stream)
        _build.check('pccf_gemm', err, f'M={m}, N={n}, K={k}, {groups} group(s)')

    def norm(self, src, weight, bias, out) -> None:
        err = self.lib.pccf_layer_norm(src.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                       src.shape[0], self.d, LN_EPS, self.stream)
        _build.check('pccf_layer_norm', err, f'rows={src.shape[0]}, d={self.d}')

    def attend(self, q, k, v, out, n_heads: int) -> None:
        """Multi-head attention, ``q, out (b * t, d)`` and ``k, v (b * t_k, d)``,
        each a row-strided 2-D view (``k`` and ``v`` with one stride); heads
        past :data:`WIDE_HEAD` wide through :func:`attention_wide_cuda`."""
        if self.d // n_heads > WIDE_HEAD:
            attention_wide_cuda(self, q, k, v, out, n_heads)
        else:
            self._attention(q, k, v, out, n_heads)

    def _attention(self, q, k, v, out, n_heads: int) -> None:
        d, t_k = self.d, k.shape[0] // self.b
        if k.stride(0) != v.stride(0):
            raise ValueError(f'pccf_attention: k and v strides differ ({k.stride(0)}, {v.stride(0)})')
        err = self.lib.pccf_attention(q.data_ptr(), q.stride(0), k.data_ptr(), v.data_ptr(), k.stride(0),
                                      out.data_ptr(), out.stride(0), self.b, self.t, t_k, n_heads, d // n_heads,
                                      self.stream)
        _build.check('pccf_attention', err, f'B={self.b}, T={self.t}, T_kv={t_k}, {n_heads} heads of {d // n_heads}')

    def project(self, src, p: dict, prefix: str, names: str) -> list[torch.Tensor]:
        """One ``(rows, d)`` product of ``src`` per projection in ``names``,
        all in one grouped launch."""
        outs = [self.scratch(f'{prefix}{name}', src.shape[0], self.d) for name in names]
        self.gemm(src, [p[f'w{prefix}{name}'] for name in names], [p[f'b{prefix}{name}'] for name in names], outs)
        return outs

    def self_attention(self, res, p: dict, n_heads: int) -> None:
        h, att = self.scratch('h', self.m, self.d), self.scratch('att', self.m, self.d)
        self.norm(res, p['ln1_w'], p['ln1_b'], h)
        self.attend(*self.project(h, p, '', 'qkv'), att, n_heads)
        self.gemm(att, [p['wo']], [p['bo']], [res], res)

    def cross_attention(self, res, memory, p: dict, n_heads: int) -> None:
        h, att = self.scratch('h', self.m, self.d), self.scratch('att', self.m, self.d)
        self.norm(res, p['lnx_w'], p['lnx_b'], h)
        self.attend(*self.project(h, p, 'x', 'q'), *self.project(memory, p, 'x', 'kv'), att, n_heads)
        self.gemm(att, [p['wxo']], [p['bxo']], [res], res)

    def feed_forward(self, res, p: dict) -> None:
        h = self.scratch('h', self.m, self.d)
        f = self.scratch('ff', self.m, p['w1'].shape[0])
        self.norm(res, p['ln2_w'], p['ln2_b'], h)
        self.gemm(h, [p['w1']], [p['b1']], [f], gelu=True)
        self.gemm(f, [p['w2']], [p['b2']], [res], res)

    def encoder(self, res, layers: list[dict], n_heads: int) -> None:
        """Run pre-norm encoder layers over ``res`` in place."""
        self.split(stack_weights(layers))
        for p in layers:
            self.self_attention(res, p, n_heads)
            self.feed_forward(res, p)

    def decoder(self, res, memory, layers: list[dict], n_heads: int) -> None:
        """Run pre-norm decoder layers (self, cross on ``memory``, FF) in place."""
        self.split(stack_weights(layers))
        for p in layers:
            self.self_attention(res, p, n_heads)
            self.cross_attention(res, memory, p, n_heads)
            self.feed_forward(res, p)


def gemm_bf16w_cuda(stacks: Stacks, a, wts: list, biases: list, outs: list, res=None, res_rows: int = 0,
                    gelu: bool = False) -> None:
    """One launch of ``pccf_gemm_bf16w``: :meth:`Stacks.gemm` with bf16
    weights, ``outs[g] = a · wts[g]ᵀ + biases[g] [GELU] + res[row %
    res_rows]`` in float32 arithmetic on the weights widened exactly
    (:func:`gemm_plain`).  Counts its launches: the server's bf16 cast runs
    the CVAE chain's and the stacks' GEMMs through it."""
    n, k = wts[0].shape
    m, groups = a.shape[0], len(wts)
    if not all(w.is_contiguous() for w in wts):
        raise ValueError('pccf_gemm_bf16w: the weights must be contiguous')
    ops = _pointers([*wts, *biases, *outs])
    err = stacks.lib.pccf_gemm_bf16w(a.data_ptr(), groups, ops, res.data_ptr() if res is not None else None,
                                     m, n, k, res_rows or m, int(gelu), stacks.stream)
    _build.check('pccf_gemm_bf16w', err, f'M={m}, N={n}, K={k}, {groups} group(s)')
    gemm_bf16w_cuda.launches += 1


gemm_bf16w_cuda.launches = 0


def attention_wide_cuda(stacks: Stacks, q, k, v, out, n_heads: int) -> None:
    """One launch of ``pccf_attention`` at heads past :data:`WIDE_HEAD`,
    which runs its wide instance (``attention_wide_kernel``): :meth:`Stacks.attend`
    at such heads.  The instance reads q, k and v through TMA, so each must
    start on 16 bytes.  Counts its launches apart from the stacks' own: a
    stack or chain whose heads are this wide launches it once a layer's
    attention."""
    stacks._attention(q, k, v, out, n_heads)
    attention_wide_cuda.launches += 1


attention_wide_cuda.launches = 0


def _tokens(x: torch.Tensor, name: str, pack: list[dict]) -> tuple[int, int, int]:
    _build.require(x, name, torch.float32)
    if x.dim() != 3:
        raise ValueError(f'{name}: expected (B, T, d), got {tuple(x.shape)}')
    if pack and pack[0]['wq'].device != x.device:
        raise ValueError(f'wformer: weights on {pack[0]["wq"].device}, {name} on {x.device}')
    return x.shape


def wformer_encoder_cuda(x: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    """``x (B, T, d)`` float32 on the card -> ``(B, T, d)`` through the
    encoder stack.  The guards of ``pccf_gemm`` and ``pccf_attention`` state
    the shapes covered (64-row tiles over tokens, widths in multiples of
    64, heads of any width)."""
    b, t, d = _tokens(x, 'x', pack)
    stacks = Stacks(b, t, d, x.device)
    res = x.reshape(b * t, d).clone()
    stacks.encoder(res, pack, n_heads)
    wformer_encoder_cuda.launches += 1
    return res.view(b, t, d)


def wformer_decoder_cuda(x: torch.Tensor, memory: torch.Tensor, pack: list[dict], n_heads: int) -> torch.Tensor:
    """``x (B, T, d)`` and ``memory (B, T_mem, d)`` float32 on the card ->
    ``(B, T, d)`` through the decoder stack."""
    b, t, d = _tokens(x, 'x', pack)
    bm, t_mem, dm = _tokens(memory, 'memory', pack)
    if (bm, dm) != (b, d):
        raise ValueError(f'wformer: memory {tuple(memory.shape)} does not match x {tuple(x.shape)}')
    stacks = Stacks(b, t, d, x.device)
    res = x.reshape(b * t, d).clone()
    stacks.decoder(res, memory.reshape(b * t_mem, d), pack, n_heads)
    wformer_decoder_cuda.launches += 1
    return res.view(b, t, d)


wformer_encoder_cuda.launches = 0
wformer_decoder_cuda.launches = 0

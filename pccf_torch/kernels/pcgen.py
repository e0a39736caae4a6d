"""Fused PCGen eval: the CUDA kernels ``csrc/pcgen_mix.cu`` and
``csrc/pcgen_general.cu`` and their plain version.

Replaces ``pccf/kernels/pallas_pcgen.py:133`` ``pcgen_mix_tpu``.  The decoder
builds a :class:`PCGenPack` (BatchNorm folded into the component weights)
once.  The flagship's shapes (:func:`flagship`: three component layers whose
second and third are one warpgroup-split chunk and one n16 product) run the
fp16 ``wgmma`` kernel of ``pcgen_mix.cu``, whose wrapper derives its device
layout (fp16 component weights, transposed map head) and the bounds of its
fp16 operand scales from the pack once and keeps them on the pack.  Every
other shape of the JAX package's gate (:func:`supported`: any number of
layers of any widths, any map input and number of components) runs
``pcgen_general.cu`` on the pack's fp32 weights as they are.

Both kernels have a partial mode for the expert-parallel decode
(:mod:`pccf_torch.nn.decoders`): a pack of a rank's components
(:meth:`PCGenPack.share`) gives their partial mix logits and head outputs
(:func:`pcgen_mix_partial_cuda`, :func:`pcgen_general_partial_cuda`, the
plain version :func:`plain_partial`), which the decoder sums over the ranks
and mixes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pccf_torch.kernels import _build, ops

# the shapes pccf_pcgen_mix takes, as the guard of csrc/pcgen_mix.cu states them
MAX_D0 = 1024  # kMaxD0: the joined latent of 64 points stays in shared memory in fp16
D2_WIDTHS = (64, 128, 256)  # layer 1: one chunk of layer 0, split over two warpgroups
D3 = 16  # kD3: layer 2 is one m64n16 product
MAX_MAP_IN = 64  # kMaxDm: the map head's input width
MAX_COMPONENTS = 8  # kMaxG: a mix thread keeps a point's logit and head output per component
ROWS = 64  # kRows: points per block
FP16_MAX = 65504.0  # the largest finite fp16: the kernel's component weights past it would be inf
TILE = 256  # pcgen_fused_supported's row tile: the JAX gate takes points in multiples of it


def supported(n: int, w_dim: int, conv_dims: tuple[int, ...], n_components: int) -> bool:
    """``pcgen_fused_supported`` (``pallas_pcgen.py:60-74``) without its VMEM
    budget, a TPU limit: points in multiples of 256, a 128-multiple
    ``w_dim``, at least two components, and component layers that shrink
    strictly after the first (their residual is a prefix slice).  The card
    runs every such decoder: :func:`flagship` shapes on the ``pcgen_mix``
    kernel, the others on the general kernel, at any depth."""
    dims = (w_dim, *conv_dims)
    return (n % TILE == 0 and w_dim % 128 == 0 and n_components >= 2 and len(conv_dims) >= 1
            and all(dims[i + 1] < dims[i] for i in range(1, len(dims) - 1)))


def flagship(dm: int, dims: tuple[int, ...], n_components: int, n_logits: int | None = None) -> bool:
    """Whether ``pccf_pcgen_mix`` covers a decoder: map input ``dm``, widths
    ``dims = (D0, D1, D2, D3)`` (three component layers), ``n_components``
    from 2 to 8; in partial mode (``n_logits`` the decoder's components) at
    least one of at most 8.  Any number of points: the last tile is
    masked."""
    if len(dims) != 4:
        return False
    d0, d1, d2, d3 = dims
    count = 2 <= n_components <= MAX_COMPONENTS if n_logits is None else 1 <= n_components <= n_logits <= MAX_COMPONENTS
    return (0 < d0 <= MAX_D0 and d0 % 64 == 0 and d2 in D2_WIDTHS and d1 % d2 == 0 and d1 > d2 and d3 == D3
            and 0 < dm <= MAX_MAP_IN and count)


@dataclasses.dataclass
class PCGenPack:
    """Eval weights of the PCGen map head, components, heads and mix, fp32,
    torch layouts (see :func:`pccf_torch.kernels.ops.pcgen_mix`)."""

    map_w: torch.Tensor  # (D0, Dm)
    map_b: torch.Tensor  # (D0,)
    layer_ws: tuple[torch.Tensor, ...]  # (G, Dout, Din), BatchNorm folded
    layer_bs: tuple[torch.Tensor, ...]  # (G, Dout)
    head_w: torch.Tensor  # (G, 3, D_last)
    head_b: torch.Tensor  # (G, 3)
    att_w: torch.Tensor  # (G, G * D_last)
    att_b: torch.Tensor  # (G,)
    _cuda: tuple | None = dataclasses.field(default=None, repr=False)
    _bounds: tuple[float, ...] | None = dataclasses.field(default=None, repr=False)

    def tensors(self) -> tuple:
        return (self.map_w, self.map_b, self.layer_ws, self.layer_bs, self.head_w, self.head_b, self.att_w, self.att_b)

    def dims(self) -> tuple[int, ...]:
        """``(D0, D1, ..., D_last)``."""
        return (self.map_w.shape[0], *(lw.shape[1] for lw in self.layer_ws))

    def share(self, g0: int, count: int, with_bias: bool) -> 'PCGenPack':
        """The pack of components ``[g0, g0 + count)`` for the partial mode:
        their layers and heads (a pack of ``count`` components already holds
        just those: an expert-parallel decoder's), the columns of ``att_w``
        they feed, and ``att_b`` where ``with_bias``, else zeros (one share
        adds it)."""
        d = self.head_w.shape[-1]
        mine = slice(0, count) if self.head_w.shape[0] == count else slice(g0, g0 + count)
        return PCGenPack(
            map_w=self.map_w, map_b=self.map_b,
            layer_ws=tuple(t[mine] for t in self.layer_ws), layer_bs=tuple(t[mine] for t in self.layer_bs),
            head_w=self.head_w[mine], head_b=self.head_b[mine],
            att_w=self.att_w[:, g0 * d:(g0 + count) * d],
            att_b=self.att_b if with_bias else torch.zeros_like(self.att_b))

    def n_logits(self) -> int:
        """The decoder's components: ``att_w``'s rows."""
        return self.att_w.shape[0]

    def general_operands(self) -> tuple:
        """The general kernel's operands: every weight fp32 contiguous in its
        pack layout, the component layers' weights then biases."""
        def f32(t):
            return t.detach().to(torch.float32).contiguous()

        return (f32(self.map_w), f32(self.map_b), [f32(t) for t in (*self.layer_ws, *self.layer_bs)],
                f32(self.head_w), f32(self.head_b), f32(self.att_w), f32(self.att_b))

    def cuda_operands(self) -> tuple:
        """The kernel's operand layout, built on first use.  Raises
        ``ValueError`` if a folded component weight is not finite in fp16."""
        if self._cuda is None:
            def f32(t):
                return t.detach().to(torch.float32).contiguous()

            def f16(t):
                return t.detach().to(torch.float16).contiguous()

            for i, lw in enumerate(self.layer_ws):
                top = float(lw.detach().abs().max())
                if not top <= FP16_MAX:  # also catches NaN
                    raise ValueError(f'pcgen_mix: folded layer {i} weights reach |w| = {top:.4g}, past fp16\'s '
                                     f'{FP16_MAX:g}')
            w0, w1, w2 = self.layer_ws
            b0, b1, b2 = self.layer_bs
            self._cuda = (
                f32(self.map_w.T), f32(self.map_b),
                f16(w0), f32(b0), f16(w1), f32(b1), f16(w2), f32(b2),
                f32(self.head_w), f32(self.head_b), f32(self.att_w), f32(self.att_b),
            )
            self._bounds = operand_bounds(self._cuda[2].float(), b0, self._cuda[4].float(), b1)
        return self._cuda

    def scale_bounds(self) -> tuple[float, ...]:
        """``(A0, B0, A1, B1)`` of :func:`operand_bounds` for the kernel's weights."""
        self.cuda_operands()
        return self._bounds


def operand_bounds(w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor) -> tuple[float, ...]:
    """What the kernel bounds its fp16 operands with (``csrc/pcgen_mix.cu``):
    for layers 0 and 1 the largest absolute row sum ``A`` of the weights
    ``(G, Dout, Din)`` as the kernel holds them, and the largest ``|bias|``
    ``B``; ``|h0| <= |x| (1 + A0) + B0`` and ``|h1| <= |h0| (1 + A1) + B1``.
    Read to the host once per pack."""
    return tuple(float(v) for v in torch.stack([
        w0.abs().sum(-1).max(), b0.abs().max(), w1.abs().sum(-1).max(), b1.abs().max()]).cpu())


def plain(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    return ops.pcgen_mix(m, w, *pack.tensors(), tau=tau, act_slope=act_slope)


def plain_partial(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *,
                  act_slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    return ops.pcgen_partial(m, w, *pack.tensors(), act_slope=act_slope)


def _mix_operands(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, name: str) -> tuple:
    """``(B, N, Dm, dims, the kernel's operands)`` of ``pccf_pcgen_mix``."""
    _build.require(m, 'm', torch.float32)
    if m.dim() != 3:
        raise ValueError(f'm: expected (B, N, Dm), got {tuple(m.shape)}')
    b, n, dm = m.shape
    d0 = pack.map_w.shape[0]
    _build.require(w, 'w', torch.float32, (b, d0))
    if len(pack.layer_ws) != 3:
        raise ValueError(f'{name}: the kernel runs 3 component layers, the pack has {len(pack.layer_ws)}')
    ops_ = pack.cuda_operands()
    for t in ops_:
        if t.device != m.device:
            raise ValueError(f'{name}: weights on {t.device}, inputs on {m.device}')
    return b, n, dm, pack.dims(), ops_


def pcgen_mix_cuda(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    """``m (B, N, Dm)``, ``w (B, D0)`` float32 on the card -> ``(B, N, 3)``,
    for three component layers ``D0 -> D1 -> D2 -> D3``; the guard of
    ``pccf_pcgen_mix`` states the widths it covers (:func:`flagship`)."""
    b, n, dm, dims, ops_ = _mix_operands(m, w, pack, 'pcgen_mix')
    g = pack.head_w.shape[0]
    out = torch.empty((b, n, 3), dtype=torch.float32, device=m.device)
    err = _build.lib().pccf_pcgen_mix(
        m.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in ops_), out.data_ptr(),
        b, n, dm, *dims, g, float(tau), float(act_slope), *pack.scale_bounds(), _build.stream(),
    )
    _build.check('pccf_pcgen_mix', err, f'N={n}, dims={dims}, Dm={dm}, G={g}')
    pcgen_mix_cuda.launches += 1
    return out


def pcgen_mix_partial_cuda(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *,
                           act_slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial mode of ``pccf_pcgen_mix`` on a share's pack
    (:meth:`PCGenPack.share`): ``(logits (B, N, G_t), heads (B, N, G_l, 3))``
    as :func:`plain_partial` computes them."""
    b, n, dm, dims, ops_ = _mix_operands(m, w, pack, 'pcgen_mix_partial')
    g, gt = pack.head_w.shape[0], pack.n_logits()
    logits = torch.empty((b, n, gt), dtype=torch.float32, device=m.device)
    heads = torch.empty((b, n, g, 3), dtype=torch.float32, device=m.device)
    err = _build.lib().pccf_pcgen_mix_partial(
        m.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in ops_), logits.data_ptr(), heads.data_ptr(),
        b, n, dm, *dims, g, gt, float(act_slope), *pack.scale_bounds(), _build.stream(),
    )
    _build.check('pccf_pcgen_mix_partial', err, f'N={n}, dims={dims}, Dm={dm}, G={g} of {gt}')
    pcgen_mix_partial_cuda.launches += 1
    return logits, heads


def _general(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, partial: bool, tau: float, act_slope: float):
    """Launch ``pccf_pcgen_general`` (or its partial mode): the mixed cloud,
    or the share's logits and heads."""
    name = 'pcgen_general_partial' if partial else 'pcgen_general'
    _build.require(m, 'm', torch.float32)
    if m.dim() != 3:
        raise ValueError(f'm: expected (B, N, Dm), got {tuple(m.shape)}')
    b, n, dm = m.shape
    dims, g, gt = pack.dims(), pack.head_w.shape[0], pack.n_logits()
    _build.require(w, 'w', torch.float32, (b, dims[0]))
    if pack.map_w.shape[1] != dm:
        raise ValueError(f'{name}: the map head takes {pack.map_w.shape[1]} inputs, m has {dm}')
    map_w, map_b, layers, head_w, head_b, att_w, att_b = pack.general_operands()
    if map_w.device != m.device:
        raise ValueError(f'{name}: weights on {map_w.device}, inputs on {m.device}')
    lib = _build.lib()
    n_layers = len(dims) - 1
    dims_c = (ctypes.c_int * len(dims))(*dims)
    words = (lib.pccf_pcgen_general_partial_scratch(b, n, dm, n_layers, dims_c, g, gt) if partial
             else lib.pccf_pcgen_general_scratch(b, n, dm, n_layers, dims_c, g))
    if words < 0:
        raise ValueError(f'pccf_{name}: the kernel does not cover N={n}, dims={dims}, Dm={dm}, G={g} of {gt} '
                         f'(component layers non-expanding after the first)')
    scratch = torch.empty(max(words, 1), dtype=torch.float32, device=m.device)
    # from pinned memory without waiting: a pageable upload would wait for the work queued before it
    table = torch.tensor([t.data_ptr() for t in layers] + list(dims), dtype=torch.int64).pin_memory().to(
        m.device, non_blocking=True)
    head = (m.data_ptr(), w.data_ptr(), map_w.data_ptr(), map_b.data_ptr(), table.data_ptr(), n_layers, dims_c,
            head_w.data_ptr(), head_b.data_ptr(), att_w.data_ptr(), att_b.data_ptr())
    if partial:
        logits = torch.empty((b, n, gt), dtype=torch.float32, device=m.device)
        heads = torch.empty((b, n, g, 3), dtype=torch.float32, device=m.device)
        err = lib.pccf_pcgen_general_partial(*head, logits.data_ptr(), heads.data_ptr(),
                                             scratch.data_ptr() if words > 0 else None, b, n, dm, g, gt,
                                             float(act_slope), _build.stream())
        result = (logits, heads)
    else:
        out = torch.empty((b, n, 3), dtype=torch.float32, device=m.device)
        err = lib.pccf_pcgen_general(*head, out.data_ptr(), scratch.data_ptr() if words > 0 else None, b, n, dm, g,
                                     float(tau), float(act_slope), _build.stream())
        result = out
    _build.check(f'pccf_{name}', err, f'N={n}, dims={dims}, Dm={dm}, G={g} of {gt}')
    return result


def pcgen_general_cuda(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *, tau: float,
                       act_slope: float) -> torch.Tensor:
    """``m (B, N, Dm)``, ``w (B, D0)`` float32 on the card -> ``(B, N, 3)``
    for any decoder of the JAX gate (:func:`supported`): component layers of
    any number and widths, non-expanding after the first, any map input and
    number of components (``csrc/pcgen_general.cu``, whose guard states the
    shapes).  The layers' pointers and widths go to the kernel as one device
    table."""
    out = _general(m, w, pack, False, tau, act_slope)
    pcgen_general_cuda.launches += 1
    return out


def pcgen_general_partial_cuda(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *,
                               act_slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial mode of ``pccf_pcgen_general`` on a share's pack:
    ``(logits (B, N, G_t), heads (B, N, G_l, 3))``, any share of one
    component or more."""
    out = _general(m, w, pack, True, 1.0, act_slope)
    pcgen_general_partial_cuda.launches += 1
    return out


pcgen_mix_cuda.launches = 0
pcgen_general_cuda.launches = 0
pcgen_mix_partial_cuda.launches = 0
pcgen_general_partial_cuda.launches = 0

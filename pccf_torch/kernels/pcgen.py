"""Fused PCGen eval: the CUDA kernel ``csrc/pcgen_mix.cu`` and its plain
version.

Replaces ``pccf/kernels/pallas_pcgen.py:133`` ``pcgen_mix_tpu``.  The decoder
builds a :class:`PCGenPack` (BatchNorm folded into the component weights)
once; the CUDA wrapper derives its device layout (bf16 component weights,
transposed map head) from the pack once and keeps it on the pack.
"""

from __future__ import annotations

import dataclasses

import torch

from pccf_torch.kernels import _build, ops


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

    def tensors(self) -> tuple:
        return (self.map_w, self.map_b, self.layer_ws, self.layer_bs, self.head_w, self.head_b, self.att_w, self.att_b)

    def cuda_operands(self) -> tuple:
        """The kernel's operand layout, built on first use."""
        if self._cuda is None:
            def f32(t):
                return t.detach().to(torch.float32).contiguous()

            def bf16(t):
                return t.detach().to(torch.bfloat16).contiguous()

            w0, w1, w2 = self.layer_ws
            b0, b1, b2 = self.layer_bs
            self._cuda = (
                f32(self.map_w.T), f32(self.map_b),
                bf16(w0), f32(b0), bf16(w1), f32(b1), bf16(w2), f32(b2),
                f32(self.head_w), f32(self.head_b), f32(self.att_w), f32(self.att_b),
            )
        return self._cuda


def plain(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    return ops.pcgen_mix(m, w, *pack.tensors(), tau=tau, act_slope=act_slope)


def pcgen_mix_cuda(m: torch.Tensor, w: torch.Tensor, pack: PCGenPack, *, tau: float, act_slope: float) -> torch.Tensor:
    """``m (B, N, Dm)``, ``w (B, D0)`` float32 on the card -> ``(B, N, 3)``,
    for three component layers ``D0 -> D1 -> D2 -> D3``; the guard of
    ``pccf_pcgen_mix`` states the widths its layout covers."""
    _build.require(m, 'm', torch.float32)
    if m.dim() != 3:
        raise ValueError(f'm: expected (B, N, Dm), got {tuple(m.shape)}')
    b, n, dm = m.shape
    d0 = pack.map_w.shape[0]
    _build.require(w, 'w', torch.float32, (b, d0))
    if len(pack.layer_ws) != 3:
        raise ValueError(f'pcgen_mix: the kernel runs 3 component layers, the pack has {len(pack.layer_ws)}')
    dims = (d0, *(lw.shape[1] for lw in pack.layer_ws))
    g = pack.head_w.shape[0]
    ops_ = pack.cuda_operands()
    for t in ops_:
        if t.device != m.device:
            raise ValueError(f'pcgen_mix: weights on {t.device}, inputs on {m.device}')
    out = torch.empty((b, n, 3), dtype=torch.float32, device=m.device)
    err = _build.lib().pccf_pcgen_mix(
        m.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in ops_), out.data_ptr(),
        b, n, dm, *dims, g, float(tau), float(act_slope), _build.stream(),
    )
    _build.check('pccf_pcgen_mix', err, f'N={n}, dims={dims}, Dm={dm}, G={g}')
    pcgen_mix_cuda.launches += 1
    return out


pcgen_mix_cuda.launches = 0

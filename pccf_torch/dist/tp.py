"""The collectives of a sharded layer: tensor and expert parallelism on a
``(dp, mp)`` grid (:class:`~pccf_torch.dist.sharding.Grid`).

JAX shards a parameter and lets GSPMD place the collectives
(``pccf/dist/sharding.py``, ``pccf/train/tp.py:1-13``).  The port writes
them by hand, as two autograd functions over the grid's ``mp`` group:

- :func:`copy_to_mp`: the identity forward, and the sum of the cotangent
  over ``mp`` backward.  A replicated tensor that feeds a rank's column
  slice goes through it: each rank's cotangent covers its columns only;
- :func:`gather_from_mp`: the ranks' slices side by side along a dimension
  forward (an all-reduce of a zeroed buffer into which each rank writes its
  slice: adding zeros is exact), and this rank's slice of the cotangent
  backward: the gathered tensor is replicated, so every rank holds the
  whole cotangent and counts it once;

and :func:`psum_mp`, the sum over ``mp`` of a result every rank then holds
(the expert-parallel mixture), whose backward is the identity.  Only
``all_reduce`` is called, gloo's collective for CUDA tensors.

A column-sharded parameter (:class:`ColumnShard`, from
:func:`~pccf_torch.dist.sharding.shard_params_tp`) keeps this rank's slice
as its ``nn.Parameter`` (``owner.parametrizations.<name>.original``), so its
memory, its gradient and its optimiser moments divide by ``mp``; reading
``owner.<name>`` gathers it (:class:`Gathered`), with the gradient of the
slice as above.  So the layers run as on one device and know nothing of the
sharding (``chip_smoke.py`` prints, for each sharded layer of the flagship,
the bytes of its gathered weight beside those of its output).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from pccf_torch.dist.sharding import Grid

Tensor = torch.Tensor


def _all_reduce(x: Tensor, grid: Grid, axis: str) -> Tensor:
    x = x.contiguous().clone()
    if grid.group(axis) is not None:
        dist.all_reduce(x, group=grid.group(axis))
    return x


def gathered(x: Tensor, grid: Grid, axis: str, dim: int) -> Tensor:
    """The ranks' ``x`` side by side along ``dim``, this rank's at its index;
    no gradient."""
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= grid.size(axis)
    buf = x.new_zeros(shape)
    buf.narrow(dim, grid.index(axis) * x.shape[dim], x.shape[dim]).copy_(x)
    if grid.group(axis) is not None:
        dist.all_reduce(buf, group=grid.group(axis))
    return buf


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.args = (grid, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis, dim):
        ctx.args = (grid, axis, dim % x.dim(), x.shape[dim])
        return gathered(x, grid, axis, dim)

    @staticmethod
    def backward(ctx, g):
        grid, axis, dim, length = ctx.args
        return g.narrow(dim, grid.index(axis) * length, length).contiguous(), None, None, None


class _PsumMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis):
        return _all_reduce(x, grid, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_mp(x: Tensor, grid: Grid, axis: str = 'mp') -> Tensor:
    """``x`` as it is; its gradient summed over ``axis``."""
    return _CopyToMP.apply(x, grid, axis)


def gather_from_mp(x: Tensor, grid: Grid, axis: str = 'mp', dim: int = -1) -> Tensor:
    """The ranks' slices along ``dim``; the gradient this rank's slice of
    the (replicated) cotangent."""
    return _GatherFromMP.apply(x, grid, axis, dim)


def psum_mp(x: Tensor, grid: Grid, axis: str = 'mp') -> Tensor:
    """The sum over ``axis`` of ``x``, replicated; the gradient the identity."""
    return _PsumMP.apply(x, grid, axis)


@dataclasses.dataclass(eq=False)
class ColumnShard:
    """A parameter sharded over ``axis``: its one-device ``shape``, the
    ``view`` of it in which the sharded (the flax kernel's last) axis is
    whole, and that axis ``dim``."""

    name: str
    grid: Grid
    axis: str
    shape: tuple[int, ...]
    view: tuple[int, ...]
    dim: int

    @property
    def width(self) -> int:
        return self.view[self.dim] // self.grid.size(self.axis)

    @property
    def lo(self) -> int:
        return self.grid.index(self.axis) * self.width

    def take(self, full: Tensor) -> Tensor:
        """This rank's slice of the one-device tensor."""
        return full.reshape(self.view).narrow(self.dim, self.lo, self.width).contiguous()

    def gather(self, local: Tensor) -> Tensor:
        """The one-device tensor from the ranks' slices, differentiable."""
        return gather_from_mp(local, self.grid, self.axis, self.dim).reshape(self.shape)

    def full(self, local: Tensor) -> Tensor:
        """:meth:`gather` without a gradient."""
        return gathered(local.detach(), self.grid, self.axis, self.dim).reshape(self.shape)


class Gathered(nn.Module):
    """The parametrization of a column-sharded parameter: the stored
    ``original`` is this rank's slice, the parameter read is the gathered
    one-device tensor."""

    def __init__(self, shard: ColumnShard) -> None:
        super().__init__()
        self.shard = shard

    def forward(self, local: Tensor) -> Tensor:
        return self.shard.gather(local)

    def right_inverse(self, full: Tensor) -> Tensor:
        return self.shard.take(full)


def shard_parameter(owner: nn.Module, attr: str, shard: ColumnShard) -> None:
    """Keep this rank's slice of ``owner.<attr>`` as the parameter."""
    parametrize.register_parametrization(owner, attr, Gathered(shard), unsafe=True)


def shard_of(owner: nn.Module, attr: str = 'weight') -> ColumnShard | None:
    """The shard of ``owner.<attr>``, or None where it is not sharded."""
    if not parametrize.is_parametrized(owner, attr):
        return None
    p = owner.parametrizations[attr]
    return next((m.shard for m in p if isinstance(m, Gathered)), None)


def layouts(model: nn.Module) -> dict[str, ColumnShard]:
    """Every sharded parameter of ``model`` by its one-device name."""
    out = {}
    for prefix, mod in model.named_modules():
        if parametrize.is_parametrized(mod):
            for attr in mod.parametrizations:
                shard = shard_of(mod, attr)
                if shard is not None:
                    out[f'{prefix}.{attr}' if prefix else attr] = shard
    return out


def one_device_name(name: str) -> str:
    """``a.parametrizations.weight.original`` -> ``a.weight``."""
    return name.replace('.parametrizations.', '.').replace('.original', '') if '.parametrizations.' in name else name


def one_device_state(model: nn.Module) -> dict[str, Tensor]:
    """The ``state_dict`` the model would have on one device: every sharded
    parameter gathered (a collective: every rank of the row calls it),
    under its one-device name."""
    state = {}
    shards = layouts(model)
    for name, value in model.state_dict().items():
        name = one_device_name(name)
        state[name] = shards[name].full(value) if name in shards else value
    return state


def load_one_device_state(model: nn.Module, state: dict[str, Tensor]) -> None:
    """Load a one-device ``state_dict`` into a sharded model: each sharded
    parameter takes this rank's slice."""
    shards = layouts(model)
    mine = {}
    for name in model.state_dict():
        key = one_device_name(name)
        mine[name] = shards[key].take(state[key]) if key in shards else state[key]
    model.load_state_dict(mine, strict=True)


@dataclasses.dataclass(eq=False)
class ExpertShard:
    """This rank's components ``[g0, g0 + count)`` of a PCGen decoder's
    ``n_components``, sharded over ``axis`` (the expert-parallel decode,
    :func:`~pccf_torch.dist.sharding.shard_variables_ep`)."""

    grid: Grid
    axis: str
    g0: int
    count: int
    n_components: int

    def copy(self, x: Tensor) -> Tensor:
        return copy_to_mp(x, self.grid, self.axis)

    def gather(self, x: Tensor) -> Tensor:
        """The ranks' components along the leading axis, differentiable."""
        return gather_from_mp(x, self.grid, self.axis, 0)

    def columns(self, t: Tensor) -> Tensor:
        """This rank's components (the last axis) of a replicated tensor, its
        gradient whole on every rank."""
        return copy_to_mp(t, self.grid, self.axis).narrow(-1, self.g0, self.count)

    def psum(self, x: Tensor) -> Tensor:
        return psum_mp(x, self.grid, self.axis)

    def summed(self, x: Tensor) -> Tensor:
        """:meth:`psum` without a gradient."""
        return _all_reduce(x, self.grid, self.axis)

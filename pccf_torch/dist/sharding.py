"""The ``(dp, mp)`` grid of ranks and the layout rules of tensor and expert
parallelism over it (``pccf/dist/sharding.py``).

JAX lays the first ``n`` devices out as ``devices.reshape(n // mp, mp)``
with the axes ``('dp', 'mp')`` (``make_2d_mesh``, ``sharding.py:84-102``);
the port lays the first ``n`` ranks of the process group out the same way,
row-major: rank ``r`` sits at ``(r // mp, r % mp)``.  A rank's ``mp`` group
is its row and its ``dp`` group its column, ``torch.distributed`` groups
over which the sharded functions (:mod:`pccf_torch.dist.sp`,
:mod:`pccf_torch.dist.tp`, :mod:`pccf_torch.dist.pp`) run their
collectives.  ``make_2d_grid(n, mp=n)`` is the 1-D grid, the whole world as
``mp``.  An axis of one rank has no group and runs no collective, so a
one-rank grid, with or without a process group, computes what one device
does.

The layout rules (``sharding.py:24-81``) decide on the flax leaf each port
parameter converts from (:mod:`pccf_torch.convert`), by the leaf's name and
flax shape (:func:`flax_leaf`):

- :func:`tp_spec` / :func:`shard_params_tp`: a ``kernel`` or ``embedding``
  leaf of two or more axes whose last axis is at least ``min_size`` and
  divisible by ``mp`` is sharded column-parallel, on that axis (a dense
  weight's rows in torch's ``(out, in)``, the middle axis of a stacked or
  grouped one, the head dimension of an attention projection).  This rank
  keeps its slice (:class:`~pccf_torch.dist.tp.ColumnShard`);
- :func:`ep_spec` / :func:`shard_variables_ep`: the leading component axis
  of the PCGen decoder's ``components`` and ``component_heads`` (their
  parameters and BatchNorm statistics) is sharded over ``mp``; this rank
  keeps its ``G / mp`` components.  Everything else stays replicated.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from pccf_torch.dist import mesh

AXES = ('dp', 'mp')


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on a ``(dp, mp)`` grid: ``rank`` (``None`` outside
    the grid's first ``dp · mp`` ranks) and the groups of its row (``mp``)
    and column (``dp``), ``None`` on an axis of one rank."""

    dp: int
    mp: int
    rank: int | None
    groups: dict[str, dist.ProcessGroup | None]

    def size(self, axis: str) -> int:
        return {'dp': self.dp, 'mp': self.mp}[_axis(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if self.rank is None:
            raise ValueError('this rank lies outside the grid')
        return self.rank // self.mp if _axis(axis) == 'dp' else self.rank % self.mp

    def group(self, axis: str) -> dist.ProcessGroup | None:
        return self.groups[_axis(axis)]


def _axis(axis: str) -> str:
    if axis not in AXES:
        raise ValueError(f'unknown grid axis {axis!r}: the axes are {AXES}')
    return axis


def make_2d_grid(n_devices: int, mp: int = 2) -> Grid:
    """The ``(dp, mp)`` grid over the first ``n_devices`` ranks.  Every rank
    of the process group calls it, in the same order as its other
    collectives: each row's and each column's group is made on every rank,
    rows first.  Raises on an impossible layout, as ``make_2d_mesh`` does:
    ``RuntimeError`` for fewer ranks than ``n_devices``, ``ValueError`` when
    ``mp`` does not divide it."""
    world = mesh.world_size()
    if world < n_devices:
        raise RuntimeError(f'requested a {n_devices}-rank grid but only {world} rank(s) are in the process group')
    if n_devices % mp:
        raise ValueError(f'cannot lay out {n_devices} ranks as (dp, mp={mp}): {n_devices} % {mp} != 0')
    dp, r = n_devices // mp, mesh.rank()
    inside = r < n_devices
    groups: dict[str, dist.ProcessGroup | None] = {'dp': None, 'mp': None}
    if mp > 1:
        for row in range(dp):
            group = dist.new_group(list(range(row * mp, (row + 1) * mp)))
            if inside and r // mp == row:
                groups['mp'] = group
    if dp > 1:
        for col in range(mp):
            group = dist.new_group(list(range(col, n_devices, mp)))
            if inside and r % mp == col:
                groups['dp'] = group
    return Grid(dp, mp, r if inside else None, groups)


def tp_spec(leaf: str, flax_shape: tuple[int, ...], mp: int, min_size: int) -> bool:
    """Whether JAX's ``tp_spec`` shards a flax leaf named ``leaf`` of
    ``flax_shape`` over ``mp`` ranks: column parallel on its last axis."""
    return (len(flax_shape) >= 2 and flax_shape[-1] >= min_size and flax_shape[-1] % mp == 0
            and ('kernel' in leaf or 'embedding' in leaf))


def flax_leaf(owner, attr: str, role: tuple[str, int] | None = None) -> tuple[str, tuple, tuple, int]:
    """``(leaf name, flax shape, view, dim)`` of the parameter ``attr`` of
    ``owner``: the flax leaf it converts from (``pccf_torch/convert.py``)
    and the view of the torch tensor in which the flax leaf's last axis is
    the whole axis ``dim``.  ``role`` is ``(projection, heads)`` for the
    projections of an attention."""
    from torch import nn

    from pccf_torch.nn.encoders import EdgeConvBlock
    from pccf_torch.nn.layers import BatchNorm, GroupedLinear, StackedLinear

    shape = tuple(getattr(owner, attr).shape)
    if isinstance(owner, (BatchNorm, nn.LayerNorm)):
        return ('scale' if attr == 'weight' else attr), shape, shape, len(shape) - 1
    if attr != 'weight':
        return attr, shape, shape, len(shape) - 1
    if isinstance(owner, nn.Linear) and role is not None and role[0] in ('query', 'key', 'value'):
        heads = role[1]
        out, e = shape  # flax (E, H, hd): the head dimension
        return 'kernel', (e, heads, out // heads), (heads, out // heads, e), 1
    if isinstance(owner, nn.Linear) and role is not None:  # out: flax (H, hd, E)
        e, inner = shape
        return 'kernel', (role[1], inner // role[1], e), shape, 0
    if isinstance(owner, (nn.Linear, EdgeConvBlock)):  # (out, in) <- (in, out)
        return 'kernel', shape[::-1], shape, 0
    if isinstance(owner, StackedLinear):  # (G, out, in) <- (G, in, out)
        return 'kernel', (shape[0], shape[2], shape[1]), shape, 1
    if isinstance(owner, GroupedLinear):  # (G, gout, gin) <- grouped_kernel (G, gin, gout)
        return 'grouped_kernel', (shape[0], shape[2], shape[1]), shape, 1
    return attr, shape, shape, len(shape) - 1


def _roles(model) -> dict[int, tuple[str, int]]:
    from pccf_torch.nn.layers import MultiHeadAttention

    roles = {}
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            for role in ('query', 'key', 'value', 'out'):
                roles[id(getattr(mod, role))] = (role, mod.n_heads)
    return roles


def tp_layout(model, mp: int, min_size: int = 256) -> dict[str, tuple[str, tuple, tuple, int]]:
    """Every parameter of ``model`` that :func:`tp_spec` shards over ``mp``
    ranks: its name -> :func:`flax_leaf`'s record."""
    roles, out = _roles(model), {}
    for prefix, mod in model.named_modules():
        for attr, _ in mod.named_parameters(recurse=False):
            leaf = flax_leaf(mod, attr, roles.get(id(mod)))
            if tp_spec(leaf[0], leaf[1], mp, min_size):
                out[f'{prefix}.{attr}' if prefix else attr] = leaf
    return out


def shard_params_tp(model, grid: Grid, axis: str = 'mp', min_size: int = 256) -> dict:
    """Shard ``model``'s parameters column-parallel over ``axis`` in place
    (``sharding.py:39-47``): each one :func:`tp_spec` takes keeps this
    rank's slice as its ``nn.Parameter``, its one-device shape and axis in
    a :class:`~pccf_torch.dist.tp.ColumnShard`, and is gathered where it is
    read (:class:`~pccf_torch.dist.tp.Gathered`).  Returns the shards by
    parameter name."""
    from pccf_torch.dist import tp

    modules = dict(model.named_modules())
    shards = {}
    for name, (_, _, view, dim) in tp_layout(model, grid.size(axis), min_size).items():
        prefix, _, attr = name.rpartition('.')
        owner = modules[prefix]
        shard = tp.ColumnShard(name, grid, axis, tuple(getattr(owner, attr).shape), view, dim)
        tp.shard_parameter(owner, attr, shard)
        shards[name] = shard
    return shards


def ep_spec(name: str, shape: tuple[int, ...], n_components: int, ep: int) -> bool:
    """Whether JAX's ``ep_spec`` shards the leading axis of a decoder
    variable (a parameter or a BatchNorm statistic) named ``name``."""
    parts = set(name.split('.'))
    return (('components' in parts or 'component_heads' in parts) and len(shape) >= 1
            and shape[0] == n_components and n_components % ep == 0)


def shard_variables_ep(decoder, grid: Grid, n_components: int, axis: str = 'mp') -> dict[str, tuple[int, ...]]:
    """Keep this rank's ``n_components / mp`` components of the decoder's
    component stacks and heads, parameters and BatchNorm statistics, in
    place (``sharding.py:69-81``), and set ``decoder.ep``
    (:class:`~pccf_torch.dist.tp.ExpertShard`) for its forward.  Returns the
    sharded variables' names and one-device shapes; none where ``mp`` does
    not divide the components."""
    import torch

    from pccf_torch.dist import tp

    ep = grid.size(axis)
    count = n_components // ep
    g0 = grid.index(axis) * count
    modules = dict(decoder.named_modules())
    sharded = {}
    with torch.no_grad():
        for name, value in [*decoder.named_parameters(), *decoder.named_buffers()]:
            if not ep_spec(name, tuple(value.shape), n_components, ep):
                continue
            prefix, _, attr = name.rpartition('.')
            owner = modules[prefix]
            part = value[g0:g0 + count].clone()
            if attr in owner._parameters:
                setattr(owner, attr, torch.nn.Parameter(part, requires_grad=value.requires_grad))
            else:
                owner._buffers[attr] = part
            sharded[name] = tuple(value.shape)
    if sharded:
        decoder.ep = tp.ExpertShard(grid, axis, g0, count, n_components)
        decoder.packed = None
    return sharded

"""The ``(dp, mp)`` grid of ranks: the counterpart of ``make_2d_mesh``
(``pccf/dist/sharding.py:84-102``).

JAX lays the first ``n`` devices out as ``devices.reshape(n // mp, mp)``
with the axes ``('dp', 'mp')``; the port lays the first ``n`` ranks of the
process group out the same way, row-major: rank ``r`` sits at ``(r // mp,
r % mp)``.  A rank's ``mp`` group is its row and its ``dp`` group its
column, ``torch.distributed`` groups over which the sharded functions
(:mod:`pccf_torch.dist.sp`) run their collectives.  ``make_2d_grid(n,
mp=n)`` is the 1-D grid, the whole world as ``mp``.  An axis of one rank
has no group and runs no collective, so a one-rank grid, with or without a
process group, computes what one device does.  The TP/EP layout rules of
``sharding.py`` (``tp_spec``, ``shard_params_tp``, ``ep_spec``,
``shard_variables_ep``) are not ported.
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

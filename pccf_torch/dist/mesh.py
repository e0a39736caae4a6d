"""Process groups and the data-parallel step (``pccf/dist/mesh.py``).

JAX runs data parallelism as one program over a 1-D ``dp`` mesh: the global
batch is cut into contiguous shards, the parameters are replicated, and
GSPMD averages the gradients and takes BatchNorm's statistics over the
global batch.  The port runs one process a device, joined by a
``torch.distributed`` process group (rank r on ``cuda:r`` under NCCL, or on
the CPU under gloo), and makes each rank's step compute its share of the
one-device step on the same global batch:

- :func:`shard_batch` gives a rank its contiguous slice of a global batch;
- inside :func:`sharded` (the trainer's step), :func:`draw` draws a
  batch-shaped noise tensor for the global batch from the shared generator
  and keeps this rank's rows, so the ranks' generators stay in step and the
  noise is the one-rank step's;
- :func:`group_moments` is the moments function of every BatchNorm site:
  each rank sums its rows into per-*global*-group partial sums, and one
  all-reduce, which carries gradients, gives every rank every group's
  moments; :func:`expand_groups` hands each row its group's statistics;
- :func:`average_gradients` and :func:`reduce_metrics` all-reduce the
  gradients and the step metrics as one flat buffer each, in a fixed order;
- :func:`broadcast_from_main` sends rank 0's tensor to every rank.

The batch is cut over the whole world by default.  Under tensor
parallelism (:mod:`pccf_torch.train.tp`) it is cut over the grid's ``dp``
column instead (an :class:`Axis`): the ``mp`` ranks of a row hold the same
rows, draw the same noise and take BatchNorm's statistics, the gradients'
average and the metrics over their column only.

A row may also be replicated on every rank: the VampPrior's pseudo-inputs
follow the batch's rows (``w_autoencoders.py:246-254``).  Such rows come
after the rank's shard and stand after the global batch in the global
layout; rank 0 alone counts them in the statistics.

Only ``all_reduce`` and ``broadcast`` are called: the two collectives that
gloo implements for CUDA tensors, so the same code runs under NCCL and gloo.
With one process (no group, or a group of one) nothing here runs a
collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Iterator, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def initialize_distributed(rank: int, world_size: int, init_method: str, backend: str) -> None:
    """Join the process group (``mesh.py:32-58``): ``backend`` ``'nccl'``
    binds the rank to ``cuda:rank`` first.  A failure to join propagates."""
    if backend == 'nccl':
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 gating of checkpoints, trackers and logs (``mesh.py:180-183``)."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """The ranks a step's batch is cut over: this rank's ``index`` among
    them, their ``size`` and their ``group`` (None: the whole world)."""

    index: int
    size: int
    group: Any = None


def world_axis() -> Axis:
    """Every rank of the process group, or this process alone."""
    return Axis(rank(), world_size())


def shard_batch(batch: Any, axis: Axis | None = None) -> Any:
    """This rank's contiguous slice along axis 0 of every tensor of
    ``batch`` (a tensor, a tuple of them or a dataclass of them, ``None``
    leaves kept), cut over ``axis`` (the world by default).  A batch that
    the axis's size does not divide raises, as a training batch does in JAX
    (``mesh.py:101-131``, strict)."""
    axis = axis or world_axis()
    n, r = axis.size, axis.index

    def cut(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(cut(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f'training batch dim {tuple(x.shape)[:1]} is not divisible by the {n}-rank '
                             'process group; fix batch_size')
        size = x.shape[0] // n
        return x[r * size:(r + 1) * size]

    return cut(batch)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in a sharded step: ``batch`` rows of its own at
    global rows ``[rank · batch, (rank + 1) · batch)`` of the ``world`` ranks
    of ``group`` (None: the whole world)."""

    rank: int
    world: int
    batch: int
    group: Any = None

    def parts(self, n: int) -> tuple[int, list[tuple[int, int, int, bool]]]:
        """The global row count of a tensor with ``n`` local rows and its
        local parts ``(local start, global start, length, counted)``: the
        shard, then the replicated rows after it (counted on rank 0 only)."""
        if n < self.batch:
            raise ValueError(f'{n} rows in a step sharded {self.batch} rows a rank')
        tail = n - self.batch
        parts = [(0, self.rank * self.batch, self.batch, True)]
        if tail:
            parts.append((self.batch, self.batch * self.world, tail, self.rank == 0))
        return self.batch * self.world + tail, parts


_SHARD: contextvars.ContextVar[Shard | None] = contextvars.ContextVar('pccf_torch_shard', default=None)


@contextlib.contextmanager
def sharded(batch: int, axis: Axis | None = None) -> Iterator[Shard | None]:
    """The scope of one rank's share of a step of ``batch`` rows a rank,
    the batch cut over ``axis`` (the world by default): :func:`draw` and
    :func:`group_moments` inside it act for the global batch.  Over an axis
    of one rank it changes nothing."""
    axis = axis or world_axis()
    if axis.size == 1:
        yield None
        return
    token = _SHARD.set(Shard(axis.index, axis.size, batch, axis.group))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def draw(sample: Callable[[tuple[int, ...]], Tensor], shape: Sequence[int]) -> Tensor:
    """``sample(shape)``, a draw whose axis 0 is the batch; inside
    :func:`sharded` the global batch's draw, of which this rank keeps its
    rows."""
    shard = _SHARD.get()
    if shard is None:
        return sample(tuple(shape))
    n_global, parts = shard.parts(shape[0])
    full = sample((n_global, *shape[1:]))
    return torch.cat([full[g:g + size] for _, g, size, _ in parts]) if len(parts) > 1 else \
        full[parts[0][1]:parts[0][1] + parts[0][2]]


def _segments(n: int, groups: int) -> tuple[int, list[tuple[int, int, int, bool]]]:
    """The rows of each statistic group among ``n`` local rows: the group
    size and ``(group, local start, length, counted)`` in local row order."""
    shard = _SHARD.get()
    n_global, parts = shard.parts(n) if shard is not None else (n, [(0, 0, n, True)])
    if n_global % groups:
        raise ValueError(f'batch {n_global} not divisible by bn groups {groups}')
    size = n_global // groups
    segments = []
    for local, start, length, counted in parts:
        g0 = start
        while g0 < start + length:
            g1 = min((g0 // size + 1) * size, start + length)
            segments.append((g0 // size, local + g0 - start, g1 - g0, counted))
            g0 = g1
    return size, segments


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum over the ranks of the
    incoming gradients."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor) -> tuple[Tensor, None]:
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group=None) -> Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the world by default),
    differentiable."""
    return _AllReduceSum.apply(x, group)


def group_moments(terms: Sequence[Tensor | Callable[[], Tensor]], groups: int, batch_dim: int = 0) -> list[Tensor]:
    """The per-group means of each term ``(*S, n, ..., F)`` over its batch
    axis ``batch_dim`` and every axis between it and the features:
    ``(*S, G, F)``.  Group g covers rows ``[g · B/G, (g + 1) · B/G)`` of the
    **global** batch of B rows; a batch that G does not divide raises
    (``layers.py:71-72``).  In a sharded step every rank sums its rows into
    the groups' partial sums and one all-reduce of all terms gives every
    rank every group's moments, for any G that divides B and any world
    size; with one process it runs no collective, and at G = 1 it is
    ``torch.mean`` over those axes.  A term may be a function that makes
    it: the terms are made and reduced in order, so that a one-process step
    builds its graph, and sums its gradients, in the order the ungrouped
    BatchNorm did."""
    means, partial, size, per_row = [], [], 0, 1
    for term in terms:
        t = term() if callable(term) else term
        n = t.shape[batch_dim]
        axes = tuple(range(batch_dim, t.dim() - 1))
        if _SHARD.get() is None:
            if n % groups:
                raise ValueError(f'batch {n} not divisible by bn groups {groups}')
            if groups == 1:
                means.append(torch.mean(t, dim=axes).unsqueeze(-2))
            else:
                means.append(torch.mean(t.reshape(*t.shape[:batch_dim], groups, n // groups, *t.shape[batch_dim + 1:]),
                                        dim=tuple(a + 1 for a in axes)))
            continue
        size, segments = _segments(n, groups)
        per_row = math.prod(t.shape[a] for a in axes[1:])
        sums: list[Tensor | None] = [None] * groups
        for g, lo, length, counted in segments:
            if counted:
                s = t.narrow(batch_dim, lo, length).sum(dim=axes)
                sums[g] = s if sums[g] is None else sums[g] + s
        zero = t.new_zeros(t.shape[:batch_dim] + t.shape[-1:])
        partial.append(torch.stack([zero if s is None else s for s in sums], dim=-2))
    if not partial:
        return means
    flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in partial]), _SHARD.get().group)
    count = float(size * per_row)
    return [m.view(p.shape) / count for m, p in zip(flat.split([p.numel() for p in partial]), partial)]


def expand_groups(stat: Tensor, n: int, groups: int) -> Tensor:
    """Each of ``n`` local rows' statistics ``(*S, n, F)`` from the groups'
    ``(*S, G, F)``: contiguous expands, whose gradient is a sum (no
    scatter)."""
    _, segments = _segments(n, groups)
    return torch.cat([stat[..., g:g + 1, :].expand(*stat.shape[:-2], length, stat.shape[-1])
                      for g, _, length, _ in segments], dim=-2)


def average_gradients(params: Sequence[torch.nn.Parameter], axis: Axis | None = None) -> int:
    """Average the gradients of ``params`` over the ranks of ``axis`` (the
    world by default) in place: one all-reduce of their concatenation in the
    order given, divided by the axis's size.  Parameters without a gradient
    (none on any rank: the ranks run the same graph) are left out.  Returns
    the bytes all-reduced; over one rank it runs no collective and returns
    0."""
    axis = axis or world_axis()
    n = axis.size
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return 0
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis.group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def reduce_metrics(objective, metrics: dict[str, Tensor], outputs: Any, targets: Any,
                   axis: Axis | None = None) -> dict[str, Tensor]:
    """The global batch's step metrics from this rank's: the mean over the
    ranks of ``axis`` (the world by default) of each batch mean (the shards
    are equal), and each pooled metric
    (:attr:`~pccf_torch.train.objectives.Objective.pooled`) finished from the
    sum over the ranks of its sums, in one all-reduce."""
    axis = axis or world_axis()
    n = axis.size
    if n == 1:
        return metrics
    names = list(metrics)
    pooled = {name: objective.pooled[name][0](outputs, targets) for name in names if name in objective.pooled}
    means = [name for name in names if name not in pooled]
    flat = torch.cat([torch.stack([metrics[name].detach().float() for name in means]).reshape(-1) / n
                      if means else metrics[names[0]].new_zeros(0),
                      *(pooled[name].detach().float().reshape(-1) for name in pooled)])
    dist.all_reduce(flat, group=axis.group)
    out = dict(zip(means, flat[:len(means)]))
    offset = len(means)
    for name, sums in pooled.items():
        out[name] = objective.pooled[name][1](flat[offset:offset + sums.numel()].view_as(sums))
        offset += sums.numel()
    return {name: out[name] for name in names}


def broadcast_from_main(value: Tensor | None, like: Tensor) -> Tensor | None:
    """Rank 0's ``value`` (a tensor shaped as ``like``, or None) on every
    rank, as one broadcast of a flag and the tensor (``hooks.py:181-193``);
    with one process, ``value`` itself."""
    if world_size() == 1:
        return value
    flat = torch.zeros(1 + like.numel(), dtype=torch.float32, device=like.device)
    if rank() == 0 and value is not None:
        flat[0] = 1.0
        flat[1:] = value.reshape(-1).to(flat)
    dist.broadcast(flat, 0)
    return flat[1:].view(like.shape).to(like.dtype) if flat[0].item() else None

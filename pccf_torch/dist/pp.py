"""GPipe pipeline parallelism over a stack of layers (``pccf/dist/pp.py``).

The W-nets' transformers are stacks of pre-norm layers; this module runs such
a stack as a pipeline over a grid axis (:class:`~pccf_torch.dist.sharding.Grid`,
the 1-D grid ``make_2d_grid(S, mp=S)`` for ``S`` stages): stage ``i`` holds
the ``L / S`` consecutive layers ``[i · L/S, (i + 1) · L/S)``
(:func:`shard_stacked_params`), the batch is cut into ``n_micro``
microbatches, and at tick ``t`` of the ``n_micro + S - 1`` ticks of the
fill-drain schedule stage ``i`` applies its layers to microbatch ``t - i``.

- **The hop.** A stage passes its output to the next as the all-reduce of a
  zeroed ``(S, microbatch…)`` buffer: stage ``i`` writes slot ``i`` and
  reads slot ``i - 1``.  Every stage joins every tick's hop, the ticks on
  which it holds no microbatch included; it computes nothing on them (JAX
  computes the bubble, ``pp.py:148-152``: one SPMD program runs everywhere).
  The hop's backward is the all-reduce of the cotangents, stage ``i``
  writing its input's cotangent at slot ``i - 1`` and reading slot ``i``:
  each rank read a different slot, so the cotangents are summed
  (``mesh.all_reduce_sum``'s rule).
- **The collection.** The last stage's outputs are summed over the stages,
  the others adding zeros: a replicated result, so its backward is the
  identity (every rank holds the whole cotangent; the last stage's graph
  takes it).  The two rules differ: a sum where the identity belongs would
  count the loss ``S`` times.
- **The backward** runs in :class:`_Pipeline` as the schedule reversed,
  tick by tick, each tick's hop on every stage in the same order, so that no
  collective waits on autograd's own ordering of a stage's graph.  A
  stage's parameters get its layers' gradients; the replicated input and
  side input get the sum over the stages of theirs.

``pipeline_apply`` runs a per-layer function over stacked parameters, as
JAX's does; :func:`pipeline_run` runs any stage function, such as one call
of the stack kernels (``api.wformer_encoder`` on the stage's packs) a
microbatch in eval.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from pccf_torch.dist.sharding import Grid

Tensor = torch.Tensor


def stack_layer_params(layer_params: Sequence[dict[str, Tensor]]) -> dict[str, Tensor]:
    """Per-layer parameters (one dict of tensors a layer, the same names) on
    a new leading layer axis, each zero-padded to the largest shape among the
    layers (``pp.py:35-58``): a narrower FF layer's extra columns and rows
    are zero, which leaves its output unchanged for an activation with
    ``act(0) == 0``."""
    names = list(layer_params[0])
    if any(list(p) != names for p in layer_params):
        raise ValueError('layer parameter trees differ in structure')
    out = {}
    for name in names:
        leaves = [p[name] for p in layer_params]
        shape = [max(t.shape[d] for t in leaves) for d in range(leaves[0].dim())]
        out[name] = torch.stack([torch.nn.functional.pad(t, [v for d in reversed(range(t.dim()))
                                                             for v in (0, shape[d] - t.shape[d])])
                                 for t in leaves])
    return out


@dataclasses.dataclass
class Stage:
    """This stage's ``count`` consecutive layers of ``n_layers`` from
    ``first`` on, stacked (:func:`shard_stacked_params`)."""

    layers: dict[str, Tensor]
    n_layers: int
    first: int
    count: int


def _stages(n_layers: int, grid: Grid, axis: str) -> int:
    s = grid.size(axis)
    if n_layers % s:
        raise ValueError(f'{n_layers} layers not divisible by {axis!r} size {s}')
    return n_layers // s


def shard_stacked_params(stacked: dict[str, Tensor], grid: Grid, axis: str = 'mp') -> Stage:
    """This rank's stage of a stacked layer tree: its ``L / S`` layers,
    copied (``pp.py:61-65``)."""
    n_layers = next(iter(stacked.values())).shape[0]
    count = _stages(n_layers, grid, axis)
    first = grid.index(axis) * count
    return Stage({k: v[first:first + count].clone() for k, v in stacked.items()}, n_layers, first, count)


def _hop(y: Tensor | None, like: Tensor, grid: Grid, axis: str, write: int, read: int) -> Tensor:
    """The all-reduce of a zeroed ``(S, *like.shape)`` buffer into which this
    rank writes ``y`` at slot ``write`` (nothing where ``y`` is None or
    ``write`` is outside), read at slot ``read``."""
    s = grid.size(axis)
    buf = like.new_zeros((s, *like.shape))
    if y is not None and 0 <= write < s:
        buf[write].copy_(y)
    if grid.group(axis) is not None:
        dist.all_reduce(buf, group=grid.group(axis))
    return buf[read] if 0 <= read < s else buf[0]


def _schedule(block, params, mb: Tensor, emb: Tensor | None, grid: Grid, axis: str, keep: bool):
    """The forward schedule: this stage's outputs (the last stage's, else
    zeros) and, with ``keep``, each tick's ``(tick, h, e, params, y)`` graph."""
    s, i = grid.size(axis), grid.index(axis)
    m = mb.shape[0]
    outs = torch.zeros_like(mb)
    act, records = None, []
    for t in range(m + s - 1):
        j, y = t - i, None
        if 0 <= j < m:
            h = mb[j] if i == 0 else act
            e = emb[j] if emb is not None else None
            if keep:
                with torch.enable_grad():
                    h = h.detach().requires_grad_()
                    e = e.detach().requires_grad_() if e is not None else None
                    ps = [p.detach().requires_grad_(p.requires_grad) for p in params]
                    y = block(h, e, ps)
                records.append((t, h, e, ps, y))
            else:
                y = block(h, e, params)
            if i == s - 1:
                outs[j] = y.detach()
        if s > 1 and t < m + s - 2:
            act = _hop(y.detach() if y is not None else None, mb[0], grid, axis, i if i < s - 1 else -1, i - 1)
    return outs, records


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, grid, axis, m, has_extra, x, extra, *params):
        mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        emb = extra.reshape(m, extra.shape[0] // m, *extra.shape[1:]) if has_extra else None
        outs, records = _schedule(block, params, mb, emb, grid, axis, keep=True)
        ctx.args = (grid, axis, m, has_extra, records, x.shape, extra.shape if has_extra else None)
        ctx.params = params
        s, i = grid.size(axis), grid.index(axis)
        if i != s - 1:
            outs.zero_()
        if grid.group(axis) is not None:
            dist.all_reduce(outs, group=grid.group(axis))
        return outs.reshape(x.shape[0], *outs.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        grid, axis, m, has_extra, records, x_shape, e_shape = ctx.args
        params = ctx.params
        s, i = grid.size(axis), grid.index(axis)
        g_outs = grad.reshape(m, grad.shape[0] // m, *grad.shape[1:])
        by_tick = {r[0]: r for r in records}
        d_params = [None] * len(params)
        dmb = torch.zeros((m, x_shape[0] // m, *x_shape[1:]), dtype=grad.dtype, device=grad.device)
        demb = torch.zeros((m, e_shape[0] // m, *e_shape[1:]), dtype=grad.dtype, device=grad.device) \
            if has_extra else None
        g_next = None  # the cotangent of this stage's output at the tick being run
        for t in reversed(range(m + s - 1)):
            j, g_in = t - i, None
            if t in by_tick:
                _, h, e, ps, y = by_tick[t]
                g_y = g_outs[j] if i == s - 1 else g_next
                wanted = [h] + ([e] if e is not None else []) + [p for p in ps if p.requires_grad]
                got = torch.autograd.grad(y, wanted, g_y, allow_unused=True)
                g_in = got[0]
                if e is not None and got[1] is not None:
                    demb[j] += got[1]
                rest = iter(got[2 if e is not None else 1:])
                for k, p in enumerate(ps):
                    if p.requires_grad:
                        g = next(rest)
                        if g is not None:
                            d_params[k] = g if d_params[k] is None else d_params[k] + g
                if i == 0 and g_in is not None:
                    dmb[j] += g_in
            if s > 1 and t > 0:
                # the backward of the hop that fed tick t: the cotangents summed
                g_next = _hop(g_in if i > 0 else None, g_outs[0], grid, axis, i - 1, i)
        dx = dmb.reshape(x_shape)
        de = demb.reshape(e_shape) if has_extra else None
        if grid.group(axis) is not None:  # a replicated input: every stage's share of its gradient
            dist.all_reduce(dx, group=grid.group(axis))
            if de is not None:
                dist.all_reduce(de, group=grid.group(axis))
        return (None, None, None, None, None, dx, de, *d_params)


def pipeline_run(block: Callable, x: Tensor, grid: Grid, axis: str = 'mp', n_micro: int | None = None,
                 extra: Tensor | None = None, params: Sequence[Tensor] = ()) -> Tensor:
    """``block(h, e, params)`` (this stage's layers on a microbatch ``h``,
    with its rows ``e`` of ``extra`` or None) as a GPipe pipeline over
    ``axis`` on the replicated ``x (B, ...)``; returns ``(B, ...)``
    replicated.  ``n_micro`` (default the stages) divides B.  Differentiable
    in ``x``, ``extra`` and ``params`` where one of them requires grad."""
    s = grid.size(axis)
    b = x.shape[0]
    m = n_micro if n_micro is not None else s
    if b % m:
        raise ValueError(f'batch {b} not divisible by n_micro {m}')
    has_extra = extra is not None
    if torch.is_grad_enabled() and (x.requires_grad or (has_extra and extra.requires_grad)
                                    or any(p.requires_grad for p in params)):
        return _Pipeline.apply(block, grid, axis, m, has_extra, x, extra if has_extra else x.new_zeros(0), *params)
    mb = x.reshape(m, b // m, *x.shape[1:])
    emb = extra.reshape(m, extra.shape[0] // m, *extra.shape[1:]) if has_extra else None
    outs, _ = _schedule(block, params, mb, emb, grid, axis, keep=False)
    if grid.index(axis) != s - 1:
        outs.zero_()
    if grid.group(axis) is not None:
        dist.all_reduce(outs, group=grid.group(axis))
    return outs.reshape(b, *outs.shape[2:])


def pipeline_apply(layer_fn: Callable, stacked: dict[str, Tensor] | Stage, x: Tensor, grid: Grid, axis: str = 'mp',
                   n_micro: int | None = None, extra: Tensor | None = None) -> Tensor:
    """Apply a stacked layer sequence to ``x`` as a microbatched pipeline
    (``pp.py:68-158``).  ``layer_fn(params, h[, extra]) -> h`` applies ONE
    layer, ``params`` that layer's slice of the stack; ``stacked`` is the
    whole stack (:func:`stack_layer_params`, this stage's layers are taken)
    or this stage's (:func:`shard_stacked_params`).  ``extra`` is a
    replicated side input of the batch's rows (the cross-attention memory),
    each microbatch's rows passed with it.  Raises where the stages do not
    divide the layers or ``n_micro`` the batch."""
    if not isinstance(stacked, Stage):
        n_layers = next(iter(stacked.values())).shape[0]
        count = _stages(n_layers, grid, axis)
        first = grid.index(axis) * count
        stacked = Stage({k: v[first:first + count] for k, v in stacked.items()}, n_layers, first, count)
    names = list(stacked.layers)

    def block(h: Tensor, e: Tensor | None, params: Sequence[Tensor]) -> Tensor:
        for layer in range(stacked.count):
            p = {k: v[layer] for k, v in zip(names, params)}
            h = layer_fn(p, h) if e is None else layer_fn(p, h, e)
        return h

    return pipeline_run(block, x, grid, axis, n_micro, extra, [stacked.layers[k] for k in names])


def stage_of(items: Sequence[Any], grid: Grid, axis: str = 'mp') -> list[Any]:
    """This rank's stage of a per-layer list (the stack kernels' packs)."""
    count = _stages(len(items), grid, axis)
    first = grid.index(axis) * count
    return list(items[first:first + count])

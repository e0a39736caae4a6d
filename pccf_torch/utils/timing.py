"""The marginal time of a step: what a step costs once a chain of them runs
back to back (``bench.py:103`` ``_marginal_scan_time``, which chains the
step in a ``lax.scan``).

:func:`marginal_time` chains ``step`` ``k_short`` and ``k_long`` times,
carry in and carry out, takes the best of ``repeats`` runs of each length,
and returns ``(t_long - t_short) / (k_long - k_short)`` in seconds: the
fixed costs of a chain (its first launches, the host's first dispatches,
the events) cancel.  On the card a run is timed between one pair of CUDA
events, behind a spin kernel that lasts as long as the host takes to
enqueue the chain, as ``chip_smoke.time_ms`` times a kernel, so the events
see the device's time and not the host's dispatch (a step that waits on
the host still shows its wait).  On the CPU a run is timed by
``time.perf_counter`` (or the ``clock`` given).

    per_step_s = marginal_time(step, (x,), k_short=1, k_long=9)
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

SPIN_CYCLES_PER_MS = 2e6  # the spin kernel's clock cycles a ms (an SM clock of at most ~2 GHz)


def _first_tensor(carry: Any) -> torch.Tensor | None:
    if isinstance(carry, torch.Tensor):
        return carry
    items = carry.values() if isinstance(carry, dict) else carry if isinstance(carry, (tuple, list)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def _chain(step: Callable[[Any], Any], carry: Any, k: int) -> Any:
    for _ in range(k):
        carry = step(carry)
    return carry


def marginal_time(step: Callable[[Any], Any], carry: Any, k_short: int = 2, k_long: int = 12, repeats: int = 2,
                  clock: Callable[[], float] | None = None) -> float:
    """Seconds a step of ``step`` chained from ``carry``: the best of
    ``repeats`` runs of ``k_short`` and of ``k_long`` steps, their
    difference over ``k_long - k_short``.  A marginal that is not positive
    (a short run as slow as a long one: noise) is measured again with three
    times the repeats, then raises: clamping it would report a throughput of
    ``batch / 0``.  On a CUDA carry the runs are device time between CUDA
    events; else host time by ``clock`` (``time.perf_counter``)."""
    if not 0 < k_short < k_long:
        raise ValueError(f'need 0 < k_short < k_long, got {k_short}, {k_long}')
    first = _first_tensor(carry)
    on_card = first is not None and first.is_cuda
    clock = clock or time.perf_counter
    _chain(step, carry, k_short)  # warm: first launches, allocator, lazy builds
    if on_card:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        _chain(step, carry, k_long)
        host_ms_per_step = (time.perf_counter() - t0) * 1e3 / k_long
        torch.cuda.synchronize()

        def seconds(k: int) -> float:
            torch.cuda._sleep(int(2 * k * host_ms_per_step * SPIN_CYCLES_PER_MS))
            start.record()
            _chain(step, carry, k)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def seconds(k: int) -> float:
            t0 = clock()
            _chain(step, carry, k)
            return clock() - t0

    for attempt in (repeats, 3 * repeats):
        best = {k: min(seconds(k) for _ in range(attempt)) for k in (k_short, k_long)}
        marginal = (best[k_long] - best[k_short]) / (k_long - k_short)
        if marginal > 0:
            return marginal
    raise RuntimeError(f'non-positive marginal step time ({best}): the runs are noise-bound; measure again with '
                       'longer chains or more repeats')

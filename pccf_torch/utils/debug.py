"""Runtime diagnostics: NaN / Inf guards, device traces and step timing
(``pccf/utils/debug.py``).

The reference drops into its debugger from forward and backward hooks that
find a NaN or an Inf (``src/module/layers.py:18,240-258``); JAX's
counterpart is the ``jax_debug_nans`` / ``jax_debug_infs`` switch.  Here
:func:`enable_nan_debugging` is a process-wide switch of the same role: while
it is on, every module's forward output and every gradient a module's
backward produces is checked, and the first NaN (and, with ``infs``, Inf)
raises ``FloatingPointError`` naming the module (its dotted path under the
outermost module that ran, ``DGCNNEncoder.edge_conv.0``) and, where it can
tell, the operation: a ``torch.ops.pccf`` kernel (:mod:`pccf_torch.kernels.library`),
whose output is checked on its own, or the module's own arithmetic.  The
card kernels' outputs are included.  A check reads one flag back to the
host, so it synchronises with the device: a debugging mode, not a serving
one.  :func:`profile_trace` writes a ``torch.profiler`` trace (CUDA
activity on the card) under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from typing import Iterator

import torch

from pccf_torch.kernels import library

_handles: list = []
_infs = [True]
_names: dict[int, str] = {}  # id(module) -> its dotted name under the outermost module that ran
_local = threading.local()  # .stack: the names of the modules whose forward is running on this thread


def _bad(value) -> str | None:
    """'NaN' or 'Inf' where a floating tensor in ``value`` (a tensor, a
    tuple or list, or a dataclass of them) holds one (Inf only while
    ``infs``)."""
    if isinstance(value, (tuple, list)):
        return next((b for b in map(_bad, value) if b), None)
    if hasattr(value, '__dataclass_fields__'):
        return next((b for b in (_bad(getattr(value, f)) for f in value.__dataclass_fields__) if b), None)
    if not isinstance(value, torch.Tensor) or not value.is_floating_point() or value.numel() == 0:
        return None
    if bool(torch.isnan(value).any()):
        return 'NaN'
    if _infs[0] and bool(torch.isinf(value).any()):
        return 'Inf'
    return None


def _stack() -> list[str]:
    if not hasattr(_local, 'stack'):
        _local.stack = []
    return _local.stack


def _name(module: torch.nn.Module) -> str:
    return _names.get(id(module), type(module).__name__)


def _pre_hook(module, inputs) -> None:
    if id(module) not in _names:  # the outermost module names what it holds
        root = type(module).__name__
        for sub, m in module.named_modules():
            _names.setdefault(id(m), f'{root}.{sub}' if sub else root)
    _stack().append(_name(module))


def _forward_hook(module, inputs, output) -> None:
    stack = _stack()
    if stack:
        stack.pop()
    bad = _bad(output)
    if bad:
        made = 'its inputs' if _bad(inputs) else 'its own operations'
        raise FloatingPointError(f'{bad} in the forward output of {_name(module)} ({type(module).__name__}), '
                                 f'made by {made}')


def _backward_hook(module, grad_input, grad_output) -> None:
    bad = _bad(grad_input)
    if bad:
        made = 'the gradient it was given' if _bad(grad_output) else 'its own backward'
        raise FloatingPointError(f'{bad} in the gradient of {_name(module)} ({type(module).__name__}), made by '
                                 f'{made}')


def _kernel_check(op: str, output) -> None:
    bad = _bad(output)
    if bad:
        stack = _stack()
        raise FloatingPointError(f'{bad} in the output of the kernel op pccf::{op}'
                                 + (f' in {stack[-1]}' if stack else ''))


def enable_nan_debugging(infs: bool = True) -> None:
    """Raise ``FloatingPointError`` at the first NaN (and, with ``infs``,
    Inf) that a module's forward or backward, or a kernel op, produces, for
    every module of the process until :func:`disable_nan_debugging`."""
    disable_nan_debugging()
    _infs[0] = bool(infs)
    hooks = torch.nn.modules.module
    _handles.extend([hooks.register_module_forward_pre_hook(_pre_hook),
                     hooks.register_module_forward_hook(_forward_hook, always_call=True),
                     hooks.register_module_full_backward_hook(_backward_hook)])
    library.output_check = _kernel_check


def disable_nan_debugging() -> None:
    while _handles:
        _handles.pop().remove()
    library.output_check = None
    _names.clear()
    _stack().clear()


@contextlib.contextmanager
def profile_trace(log_dir: str | pathlib.Path) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU, and
    CUDA on a machine with a card) as a Chrome trace under ``log_dir``."""
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / f'trace_{time.strftime("%Y%m%d-%H%M%S")}_{id(prof):x}.json'))


class StepTimer:
    """Lightweight wall-clock step timing with summary statistics."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> 'StepTimer':
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        import numpy as np

        arr = np.asarray(self.times)
        return {
            'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p95_s': float(np.percentile(arr, 95)),
            'total_s': float(arr.sum()),
            'count': float(len(arr)),
        }

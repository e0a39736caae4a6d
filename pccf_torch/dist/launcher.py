"""``DistributedWorker(fn, n).spawn(cfg)``: a data-parallel run over ``n``
processes (``pccf/dist/launcher.py:20-53``).

The parent picks a free local port for the TCP rendezvous, as the
reference's ``src/utils/parallel.py:17-66`` does, and starts ``n`` processes
with ``torch.multiprocessing`` (``spawn``); rank r joins the process group
and calls ``fn(cfg)``.  On the card (``user.cpu`` false) rank r takes
``cuda:r`` under NCCL, and more ranks than cards raise
(``launcher.py:34-39``): ranks are never packed onto a card.  With
``user.cpu`` the ranks run on the CPU under gloo.  The kernel library is
built once in the parent before the ranks start; they load it.  A rank that
fails ends the others and raises in the parent.
"""

from __future__ import annotations

import socket
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pccf_torch.dist.mesh import initialize_distributed


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable[..., None], world: int, init_method: str, backend: str, args: tuple) -> None:
    initialize_distributed(rank, world, init_method, backend)
    try:
        fn(*args)
        # every rank done before any leaves: a rank that left while another
        # still connected to it would fail that one's start
        dist.all_reduce(torch.zeros(1, device='cuda' if backend == 'nccl' else 'cpu'))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable[..., None], world: int, backend: str, *args: Any) -> None:
    """Run ``fn(*args)`` on ``world`` ranks of a new process group under
    ``backend`` (``'nccl'``: rank r on ``cuda:r``; ``'gloo'``: where ``fn``
    puts its tensors), joined on a free local port; waits for every rank,
    and raises if one fails.  ``fn`` and ``args`` are pickled: ``fn`` is a
    module-level function."""
    mp.start_processes(_rank_main, args=(fn, world, f'tcp://127.0.0.1:{free_port()}', backend, args),
                       nprocs=world, join=True, start_method='spawn')


class DistributedWorker:
    """Run ``work_fn(cfg)`` on each of ``n_devices`` data-parallel ranks."""

    def __init__(self, work_fn: Callable[[Any], None], n_devices: int) -> None:
        self.work_fn = work_fn
        self.n_devices = n_devices

    def spawn(self, cfg: Any) -> None:
        if cfg.user.cpu:
            backend = 'gloo'
        else:
            available = torch.cuda.device_count()
            if self.n_devices > available:
                raise RuntimeError(f'Requested {self.n_devices} devices but only {available} are attached; '
                                   'check user.n_subprocesses (one rank a card)')
            backend = 'nccl'
            from pccf_torch.kernels import _build

            _build.build()  # once, before the ranks load it
        launch(self.work_fn, self.n_devices, backend, cfg)

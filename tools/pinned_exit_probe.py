"""Whether an exception that is not a CUDA error, raised with a pinned host
buffer of an async copy in one of its traceback's frames, aborts the
interpreter when the traceback is freed at exit.

    cd <checkout> && python3 tools/pinned_exit_probe.py raise|oom

``raise``: a ValueError; ``oom``: an out-of-memory error of the card's
allocator.  Each should exit 1 with the traceback on standard error, not
134: freeing the buffer queries its stream, which fails only once a CUDA
error is pending.
"""

import sys

import torch


def fetch():
    recon = torch.randn(1000, device='cuda')
    host = torch.empty(recon.shape, pin_memory=True)
    host.copy_(recon, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    raise ValueError('an ordinary error with a pinned buffer in the frame')


def level1():
    fetch()


if __name__ == '__main__':
    mode = sys.argv[1]
    if mode == 'raise':
        level1()
    elif mode == 'oom':
        def oom():
            recon = torch.randn(1000, device='cuda')
            host = torch.empty(recon.shape, pin_memory=True)
            host.copy_(recon, non_blocking=True)
            torch.empty(1 << 45, device='cuda')
        oom()

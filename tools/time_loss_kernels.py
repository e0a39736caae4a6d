"""Time the nearest-neighbour and Sinkhorn kernels of the checkout the
command runs in, at the shapes ``chip_smoke.py`` gives them, with that
checkout's ``chip_smoke.time_ms``.

    cd <checkout> && python3 <path to>/tools/time_loss_kernels.py

It calls only ``chamfer.nn_distance_cuda(x, y)`` and
``sinkhorn.sinkhorn_cost_cuda(x1, x2)``, which every checkout since the
kernels were ported keeps, so running it from a parent's checkout and from a
change's in one call (parent, change, change, parent) compares the two
kernels at four decimals even where their C interface changed.  Needs a CUDA
card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from chip_smoke import REPS, time_ms  # noqa: E402
from pccf_torch.data import synthetic  # noqa: E402
from pccf_torch.kernels import chamfer, sinkhorn  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    gen = np.random.default_rng(0)
    for b, n, m, seed in ((2, 512, 512, 20), (8, 2048, 1024, 21), (8, 2048, 2048, 22)):
        x = torch.from_numpy(synthetic.batch(seed, b, n)).to(dev)
        noise = torch.from_numpy((0.05 * gen.standard_normal((b, m, 3))).astype(np.float32)).to(dev)
        y = (torch.from_numpy(synthetic.batch(seed + 1, b, m)).to(dev) + noise).contiguous()
        for name, fn in (('nn_distance', lambda: chamfer.nn_distance_cuda(x, y)),
                         ('sinkhorn_cost', lambda: sinkhorn.sinkhorn_cost_cuda(x, y))):
            print(f'{name} ({b}, {n}, 3) x ({b}, {m}, 3): {time_ms(fn, REPS):.4f} ms', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Time the kNN kernel and graph filtering's fused pass of the checkout the
command runs in, with that checkout's ``chip_smoke.time_ms``, at the shapes
of PERF.md's rows 1 and 14a and at serving's batch 1 (where kNN splits each
cloud's candidates), and print ptxas's registers and spills of their kernels.

    cd <checkout> && python3 <path to>/tools/time_knn_filter.py

It calls only ``knn.knn_cuda(x, k)`` and ``graph_filter.graph_filter_cuda(x)``,
which every checkout since the fused filter keeps, so running it from a
parent's checkout and from a change's in one call (parent, change, change,
parent) compares the two builds with nothing else running before them.
Needs a CUDA card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from chip_smoke import REPS, time_ms  # noqa: E402
from pccf_torch.kernels import _build, graph_filter, knn  # noqa: E402

KNN_SHAPES = ((16, 2048, 128, 25), (16, 2048, 3, 25), (1, 2048, 128, 25), (1, 2048, 3, 4))
FILTER_SHAPES = ((16, 2048), (1, 2048))


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    _build.build(verbose=True)
    for source in ('knn.cu', 'graph_filter.cu'):
        for name, regs, stores, loads in _build.kernel_resources(_build.ptxas_logs.get(source, '')):
            print(f'{source} {name}: {regs} registers, spill stores / loads {stores} / {loads} bytes', flush=True)
    rng = np.random.default_rng(0)
    for b, n, c, k in KNN_SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).cuda()
        print(f'knn ({b}, {n}, {c}) k={k}: {time_ms(lambda: knn.knn_cuda(x, k), REPS):.4f} ms', flush=True)
    for b, n in FILTER_SHAPES:
        x = 0.5 * torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).cuda()
        print(f'graph_filter ({b}, {n}, 3): {time_ms(lambda: graph_filter.graph_filter_cuda(x), REPS):.4f} ms',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Attribution of the DGCNN encoder's eval path (``profile_enc.py``).

On the marginal timer (:func:`pccf_torch.utils.timing.marginal_time`): the
kNN at the four blocks' widths (C = 3, 64, 64, 128, k = 25), the graph
max-pool at their outputs' widths (64, 64, 128, 256) over random
neighbour lists, and the final 512 -> 1024 product with the global max;
each chained on its own output, at ``batch`` clouds of ``n`` points, on the
card unless ``--cpu``.

    python -m pccf_torch.profile_enc [--batch 16] [--n 2048] [--k 25] [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch.kernels import api
from pccf_torch.profile_cf import parse_sizes
from pccf_torch.utils.timing import marginal_time

KNN_WIDTHS = (3, 64, 64, 128)
POOL_WIDTHS = (64, 64, 128, 256)


def knn_step(k: int):
    """The kNN step: the lists, fed back into the points."""
    def step(carry):
        (x,) = carry
        return (x + 1e-6 * api.knn(x, k)[..., :1].to(torch.float32),)
    return step


@torch.inference_mode()
def main(batch: int = 16, n: int = 2048, k: int = 25, k_short: int = 1, k_long: int = 9, repeats: int = 2,
         device: torch.device | str = 'cuda') -> dict[str, float]:
    """Print and return each piece's seconds."""
    device = torch.device(device)
    rng = np.random.default_rng(0)

    def randn(*shape: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    out = {}
    for i, c in enumerate(KNN_WIDTHS):
        dt = out[f'knn_{i}_c{c}'] = marginal_time(knn_step(k), (randn(batch, n, c),), k_short, k_long, repeats)
        print(f'knn   c={c:4d}: {dt * 1e3:6.2f} ms', flush=True)

    for i, c in enumerate(POOL_WIDTHS):
        idx = torch.from_numpy(rng.integers(0, n, (batch, n, k)).astype(np.int32)).to(device)

        def step_pool(carry, idx=idx):
            (x,) = carry
            return (api.graph_max_pool(x, idx) * 0.999,)

        dt = out[f'pool_{i}_c{c}'] = marginal_time(step_pool, (randn(batch, n, c),), k_short, k_long, repeats)
        print(f'pool  c={c:4d}: {dt * 1e3:6.2f} ms', flush=True)

    w = randn(512, 1024) * 0.01

    def step_final(carry):
        (x,) = carry
        y = torch.amax(x @ w, dim=1)
        return (x + 1e-6 * y[:, None, :512],)

    dt = out['final'] = marginal_time(step_final, (randn(batch, n, 512),), k_short, k_long, repeats)
    print(f'final conv 512->1024 + max: {dt * 1e3:6.2f} ms', flush=True)
    return out


if __name__ == '__main__':
    sizes, dev = parse_sizes(__doc__.split('\n\n')[0], batch=16, n=2048, k=25)
    main(**sizes, device=dev)

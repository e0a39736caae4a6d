"""The sharded-point-axis losses over the cards of one machine, against one
card.

    cd <checkout> && python3 tools/sp_scaling.py [--seed 0]

Needs two or more CUDA cards; one NCCL rank a card (``pccf_torch.dist.launch``),
the ranks laid out as a 1-D grid (``pccf_torch.dist.make_2d_grid(n, mp=n)``).
Each rank runs ``chip_smoke.sp_losses`` on its slab of the SP phase's clouds,
(8, 2048, 3) and (1, 16384, 3) (``chip_smoke.SP_SHAPES``): ``sp_chamfer``,
``sp_match_cost`` and ``sp_knn``, values and slab gradients, the launches
of the Chamfer call, the match cost's peak memory on its card and each
loss's host clock; ``chip_smoke.sp_check`` holds them to the one-card
functions on card 0 as ``chip_smoke.auction_sp_phase`` holds two gloo ranks
sharing a card.  What N cards add: each card holds ``N/n`` of the match
cost's ``(N, M)`` plan, and the collectives run over NVLink.

Prints the cards' names and power limits, one JSON line of the numbers as
its last line, and exits non-zero when a check fails or fewer than two
cards are attached.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def scaling(seed: int, n: int, dev: torch.device, check, root: str) -> dict:
    """The SP losses on ``n`` ranks against one card (``dev``); the numbers
    of the JSON line."""
    from pccf_torch.dist import launch

    clouds = cs.sp_clouds(np.random.default_rng([seed, 20]))
    payload = os.path.join(root, 'sp_payload.pt')
    torch.save(clouds, payload)
    t0 = time.perf_counter()
    launch(cs.sp_rank, n, 'nccl' if dev.type == 'cuda' else 'gloo', payload, root)
    print(f'{n} ranks took {time.perf_counter() - t0:.1f} s, the processes\' start included', flush=True)
    ranks = [torch.load(os.path.join(root, f'sp_rank{r}.pt'), weights_only=False) for r in range(n)]
    cs.sp_check(check, dev, clouds, ranks, 'ranks, one a card')
    return {f'({b}, {points}, 3)': {f'{name}_{what}': [r[i][f'{name}_{what}'] for r in ranks]
                                    for name in ('chamfer', 'match') for what in ('ms', 'peak')}
            for i, (b, points) in enumerate(cs.SP_SHAPES)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f'sp_scaling: {n} CUDA card(s); sharding the point axis over cards needs two or more', file=sys.stderr)
        return 2
    from pccf_torch.kernels import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.lib()
    failures = []

    def check(ok: bool, what: str) -> None:
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            failures.append(what)

    with tempfile.TemporaryDirectory(prefix='pccf_sp_') as root:
        numbers = scaling(args.seed, n, torch.device('cuda', 0), check, root)
    if failures:
        print(f'sp_scaling: {len(failures)} check(s) failed', file=sys.stderr)
        return 1
    print(json.dumps({'cards': n, 'kind': torch.cuda.get_device_name(0), 'ranks': numbers}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Data-parallel training and serving over the cards of one machine, against
one card.

    cd <checkout> && python3 tools/dp_scaling.py [--seed 0]

Needs two or more CUDA cards; one NCCL rank a card (``pccf_torch.dist.launch``).

1. The flagship's steps of ``chip_smoke.dp_cases`` (stage 1 under ChamferEMD at
   8 x 2048 at ``PCCF_BN_GROUPS`` 1 and 2, stage 2 at 32, the classifier at
   16 x 2048 with dropout), and stage 1 at 8 clouds a rank (a global batch of
   8N), on N ranks, each rank held against the one-card step on the ranks'
   kNN graphs as ``chip_smoke.dp_phase`` holds two gloo ranks
   (``chip_smoke.dp_check``: exact launches, metrics, BatchNorm statistics,
   gradients, parameters after the optimiser, the ranks bit-equal), with
   both steps' host clock and the NCCL all-reduce of the gradients alone.
   Stage 1 at 8 a rank against one card at 8 is the weak scaling (samples/s
   of N cards over N times one card's), against one card at 8N the strong
   scaling.
2. The server over the N cards (buckets up to 64N that N divides) against
   the single-card server (buckets up to 64), at requests of 64 and 64N: outputs within
   ``chip_smoke.BATCH_INVARIANCE``, exact launches (a request's a replica),
   latency in turns.

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

SERVER_REPS = 5  # requests a server a turn


def scaling(cfg, seed: int, n: int, devices: list[torch.device], check, root: str) -> dict:
    """Parts 1 and 2 over ``n`` ranks and the server over ``devices``; the
    numbers of the JSON line."""
    from pccf_torch.data.structures import Inputs, Targets
    from pccf_torch.dist import launch
    from pccf_torch.kernels import api
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.serve import CounterfactualServer

    cases = cs.dp_cases(cfg, seed)
    points = cfg.data.n_input_points
    clouds, _ = cs.labelled_clouds(seed + 50, (cs.TRAIN_BATCH * n // 2,) * 2, points)
    cloud = torch.from_numpy(clouds)
    cases.append({**cases[0], 'batch': (Inputs(cloud), Targets(cloud), None)})
    names = (f'stage 1 ChamferEMD {cs.TRAIN_BATCH} x {points}', 'stage 1, PCCF_BN_GROUPS=2', 'stage 2',
             'classifier, dropout', f'stage 1 ChamferEMD {cs.TRAIN_BATCH * n} x {points}')
    payload = os.path.join(root, 'payload.pt')
    torch.save((cfg, seed, cases), payload)
    t0 = time.perf_counter()
    launch(cs.dp_rank, n, 'nccl' if devices[0].type == 'cuda' else 'gloo', payload, root)
    print(f'{n} ranks took {time.perf_counter() - t0:.1f} s, the processes\' start included', flush=True)
    ranks = [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False) for r in range(n)]
    _, one = cs.dp_check(check, cfg, seed, devices[0], cases, names, ranks, f'{n} ranks, one a card')
    steps = {name: {'one_card_ms': o['step_ms'], 'rank_ms': [r[i]['step_ms'] for r in ranks],
                    'allreduce_ms': [r[i]['allreduce_ms'] for r in ranks],
                    'allreduce_bytes': ranks[0][i]['allreduce_bytes']}
             for i, (name, o) in enumerate(zip(names, one))}
    per_card = cs.TRAIN_BATCH / one[0]['step_ms'] * 1e3
    ranks_ms = max(r[-1]['step_ms'] for r in ranks)
    weak = {'one_card_samples_per_s': per_card, 'n_cards_samples_per_s': cs.TRAIN_BATCH * n / ranks_ms * 1e3,
            'efficiency': cs.TRAIN_BATCH / ranks_ms * 1e3 / per_card,
            'strong_speedup': one[-1]['step_ms'] / ranks_ms}
    print(f'stage 1 at {cs.TRAIN_BATCH} clouds a card: {weak["n_cards_samples_per_s"]:.1f} samples/s on {n} cards, '
          f'{per_card:.1f} on one, weak-scaling efficiency {weak["efficiency"]:.3f}; the global batch of '
          f'{cs.TRAIN_BATCH * n} on {n} cards {weak["strong_speedup"]:.2f}x one card', flush=True)

    vqvae, classifier = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vqvae, seed)
    init_from_seed(classifier, seed + 1)
    vqvae, classifier = vqvae.to(devices[0]).eval(), classifier.to(devices[0]).eval()
    # one card serves 64N in chunks of 64, N cards in one bucket of 64N: 64 a card
    single = CounterfactualServer(vqvae, classifier, seed=seed)
    dp = CounterfactualServer(vqvae, classifier, [b for b in (2 ** i for i in range(12)) if b % n == 0 and b <= 64 * n],
                              seed=seed, devices=devices)
    rng = np.random.default_rng(seed + 51)
    server = {}
    for size in (64, 64 * n):
        batch, _ = cs.labelled_clouds(seed + 52 + size, (size // 2,) * 2, cfg.data.n_target_points)
        tdim, seeds = rng.integers(0, 2, size), rng.integers(0, 1000, size)
        api.reset_launch_counts()
        got = dp.counterfactual(batch, tdim, sampling_seed=seeds)
        counts = api.launch_counts()
        want = single.counterfactual(batch, tdim, sampling_seed=seeds)
        diff = float(np.abs(got - want).max() / (np.sqrt(np.mean(want ** 2)) + 1e-12))
        want_counts = {k: n * cs.REQUEST_LAUNCHES.get(k, 0) for k in counts}
        check(counts == want_counts and diff <= cs.BATCH_INVARIANCE,
              f'server over {n} cards, request of {size}: launches {json.dumps({k: v for k, v in counts.items() if v})}'
              f' (a request\'s a replica), rel max diff to one card {diff:.2e} <= {cs.BATCH_INVARIANCE}')
        lat = {'one card': [], f'{n} cards': []}
        for which in ('one card', f'{n} cards', f'{n} cards', 'one card'):
            srv = single if which == 'one card' else dp
            for _ in range(SERVER_REPS):
                t0 = time.perf_counter()
                srv.counterfactual(batch, tdim, sampling_seed=seeds)
                lat[which].append((time.perf_counter() - t0) * 1e3)
        server[size] = {k: float(np.median(v)) for k, v in lat.items()}
        print(f'server, request of {size}: median latency ' + ', '.join(f'{k} {v:.3f} ms' for k, v in
                                                                       server[size].items())
              + f' (host clock incl. copies, {2 * SERVER_REPS} each, in turns)', flush=True)
    return {'steps': steps, 'weak': weak, 'server': server}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f'dp_scaling: {n} CUDA card(s); data parallelism over cards needs two or more', file=sys.stderr)
        return 2
    from pccf_torch.config import SliceConfig
    from pccf_torch.kernels import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.lib()
    failures = []

    def check(ok: bool, what: str) -> None:
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            failures.append(what)

    with tempfile.TemporaryDirectory(prefix='pccf_dp_') as root:
        numbers = scaling(SliceConfig(), args.seed, n, [torch.device('cuda', i) for i in range(n)], check, root)
    if failures:
        print(f'dp_scaling: {len(failures)} check(s) failed', file=sys.stderr)
        return 1
    print(json.dumps({'cards': n, 'kind': torch.cuda.get_device_name(0), **numbers}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

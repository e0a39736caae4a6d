"""Warm request latency of the port's flagship server on the card, at batch 1
and 16, for comparing two checkouts in one chip call.

    cd <checkout> && python3 <this checkout>/tools/request_latency.py [--seed 0] [--reps 20]

Imports ``pccf_torch`` from the working directory (the checkout under test),
builds the flagship models from the seed (random weights, graph filtering
on), warms the server at both batches, then times ``reps`` counterfactual
requests of each batch with the logits given (the host clock of a request,
copies included, the card synchronised after it) and reads the device busy
time of one request of each from a ``torch.profiler`` trace (the union of
its device activities).  Prints one JSON line with the medians and
quartiles, the card's name and power limit.  Run parent, change, change,
parent in one call: host-clock times differ between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def busy_ms(prof) -> float:
    """The time at least one device activity of the trace runs."""
    events = sorted(((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA))
    busy, reach = 0.0, float('-inf')
    for start, end in events:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('request_latency: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from pccf_torch.config import SliceConfig
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.serve import CounterfactualServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SliceConfig()
    vqvae, classifier = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vqvae, args.seed)
    init_from_seed(classifier, args.seed + 1)
    server = CounterfactualServer(vqvae.cuda().eval(), classifier.cuda().eval(), seed=args.seed)
    rng = np.random.default_rng(args.seed)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    out = {'checkout': os.getcwd(), 'card': smi.stdout.strip()}
    for b in (1, 16):
        clouds = (rng.standard_normal((b, cfg.data.n_input_points, 3)) / 2).astype(np.float32)
        logits = server.classify(clouds)
        args_b = (clouds, np.arange(b) % 2, logits, 1.0, np.arange(b))
        for _ in range(3):
            server.counterfactual(*args_b)
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.counterfactual(*args_b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            server.counterfactual(*args_b)
            torch.cuda.synchronize()
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        out[f'batch {b}'] = {'median_ms': float(med), 'q1_ms': float(q1), 'q3_ms': float(q3),
                             'device_busy_ms': busy_ms(prof)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

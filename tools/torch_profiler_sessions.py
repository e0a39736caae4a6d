"""Does ``torch.profiler`` see every device launch of the port's pair-sweep
kernels when a process opens one session after another?

Each pair of sessions traces one EMD call (plain launches), then, after
untraced work like ``chip_smoke.py``'s timing loops (a spin kernel and 100
calls of each kernel), one call of ``--second``; two probe sessions of 64
PyTorch launches each follow.  Every session prints the launches it saw
against those the call makes (and, where it saw fewer, the kernels missing
against a complete session of the same call), and the last line is a JSON
summary.

    python3 tools/torch_profiler_sessions.py --second sinkhorn [--pairs 3]

``--second``: ``sinkhorn`` ((8, 2048, 3)^2: its sweeps launched with
programmatic dependent launch), ``sinkhorn_rect`` ((8, 2048, 3) x (8, 1024,
3): the same kernels launched plainly), ``emd`` (plain) or ``nn`` (its
combine programmatic).  Needs a CUDA card; run each case in a fresh process,
with ``TEARDOWN_CUPTI=0`` in the environment to keep CUPTI up between
sessions (Kineto tears it down after each by default; ``chip_smoke.py``
keeps it up).
"""

import argparse
import json
import re
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pccf_torch.kernels import chamfer, emd, sinkhorn  # noqa: E402

# the pattern of each call's device kernels, and how many one call launches
KERNELS = {'emd': (r'emd_(fill|rows|cols)_kernel|sample_sum_kernel', 22),
           'sinkhorn': (r'sinkhorn_(build|sweep)_kernel|sample_sum_kernel', 26),
           'sinkhorn_rect': (r'sinkhorn_(build|sweep)_kernel|sample_sum_kernel', 26),
           'nn': (r'nn_(fold|combine)_kernel', 2),
           'probe': (r'.', 64)}


def short_name(name: str) -> str:
    found = re.search(r'(\w+_kernel)(<[^()]*>)?', name)
    return found.group(0) if found else name[:40]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--second', choices=['sinkhorn', 'sinkhorn_rect', 'emd', 'nn'], required=True)
    parser.add_argument('--pairs', type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)

    def cloud(n):
        return torch.from_numpy((rng.standard_normal((8, n, 3)) * 0.5).astype(np.float32)).to(dev)

    x1, x2, x3 = cloud(2048), cloud(2048), cloud(1024)
    z = torch.zeros(1024, device=dev)
    calls = {'emd': lambda: emd.chamfer_match_cost_cuda(x1, x2),
             'sinkhorn': lambda: sinkhorn.sinkhorn_cost_cuda(x1, x2),
             'sinkhorn_rect': lambda: sinkhorn.sinkhorn_cost_cuda(x1, x3),
             'nn': lambda: chamfer.nn_distance_cuda(x1, x2),
             'probe': lambda: [z.add_(1.0) for _ in range(64)]}
    for fn in calls.values():  # build and warm every kernel untraced
        fn()
    torch.cuda.synchronize()

    def traced(kind: str) -> list[str]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls[kind]()
            torch.cuda.synchronize()
        pattern, _ = KERNELS[kind]
        return [short_name(e.name) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and re.search(pattern, e.name)]

    seen, complete = [], {}
    for pair in range(args.pairs):
        for kind in ('emd', args.second, 'probe', 'probe'):
            if kind == args.second:
                torch.cuda._sleep(50_000_000)
                for _ in range(100):
                    calls['emd']()
                    calls[kind]()
                torch.cuda.synchronize()
            names, want = traced(kind), KERNELS[kind][1]
            entry = {'pair': pair, 'kind': kind, 'seen': len(names), 'launched': want}
            if len(names) == want:
                complete.setdefault(kind, names)
            elif kind in complete:
                entry['missing'] = sorted((Counter(complete[kind]) - Counter(names)).elements())
            seen.append(entry)
            print(f'pair {pair} {kind}: saw {len(names)} of {want} device launches', flush=True)
    lost = [s for s in seen if s['seen'] != s['launched']]
    print(json.dumps({'second': args.second, 'sessions': len(seen), 'short': len(lost), 'which': lost}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

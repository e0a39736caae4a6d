"""The auction EMD kernel under other plan constants, on the card.

Each variant is a copy of ``pccf_torch/csrc/auction_emd.cu`` with
``kMaxCluster`` (blocks a cloud at most), ``kMinItems`` (items a block owns
at least) and ``kTailBidders`` (bidders below which one block runs the
rounds; 0: never) replaced, built alone with ``nvcc`` into
``pccf_torch/_build/``.  On ``chip_smoke.py``'s auction shapes and clouds
each variant is held bit-equal to the plain version and timed (the median
of 10 samples of 5 back-to-back calls between CUDA events).  Run from the
root of a checkout, a variant as cluster,items,tail, other shapes as
B,N,M,contract:

    python3 tools/auction_variants.py [--seed 0] [--case 40,2048,2048,train ...] 16,64,32 8,64,32 16,64,0
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import auction_phases  # noqa: E402
from auction_phases import ROOT  # noqa: E402
from pccf_torch.kernels import auction_emd  # noqa: E402

CONSTANTS = ('constexpr int kMaxCluster = 16;', 'constexpr int kMinItems = 64;', 'constexpr int kTailBidders = 32;')


def variant_source(cluster: int, items: int, tail: int) -> str:
    src = (ROOT / 'pccf_torch/csrc/auction_emd.cu').read_text()
    for const in (*CONSTANTS, '? kTailBidders : 0;'):
        if src.count(const) != 1:
            raise SystemExit(f'not found once in auction_emd.cu: {const!r}')
    src = src.replace(CONSTANTS[0], f'constexpr int kMaxCluster = {cluster};')
    src = src.replace(CONSTANTS[1], f'constexpr int kMinItems = {items};')
    if tail:
        src = src.replace(CONSTANTS[2], f'constexpr int kTailBidders = {tail};')
    else:
        src = src.replace('? kTailBidders : 0;', '? 0 : 0;')
    return src


def ms(call, samples: int = 10, calls: int = 5) -> float:
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--case', action='append', default=[],
                        help="B,N,M,contract in place of chip_smoke.py's shapes (repeatable)")
    parser.add_argument('variants', nargs='*', default=['16,64,32', '16,64,16', '8,64,32', '16,128,32', '16,64,0'])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('auction_variants: needs a CUDA card', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    variants = [tuple(map(int, v.split(','))) for v in args.variants]
    names = [f'cluster {c}, items {i}, tail {t}' for c, i, t in variants]
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each, all at once
        libs = list(pool.map(lambda v: auction_phases.build(variant_source(*v), 'auction_%d_%d_%d' % v), variants))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')
    cases = [(*map(int, c.split(',')[:3]), c.split(',')[3]) for c in args.case]
    for (b, n, m, contract), (eps, iters), x1, x2 in auction_phases.clouds(args.seed, dev, cases):
        want = auction_emd.plain(x1, x2, eps, iters)
        row = []
        for name, lib in zip(names, libs):
            call, out = auction_phases.launcher(lib, x1, x2, eps, iters)
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip(out, want))
            row.append(f'{name}: {ms(call):.4f} ms{"" if same else " (NOT bit-equal to the plain version)"}')
        print(f'({b}, {n}, 3) x ({b}, {m}, 3) {contract}, rounds {want[3][:, 0].tolist()}: ' + '; '.join(row),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Where a round of the auction EMD kernel spends its time, on the card.

Copies ``pccf_torch/csrc/auction_emd.cu`` with ``%globaltimer`` marks at the
boundaries of a round's phases (on thread 0 of the first cloud's leader
block), builds the copy alone with ``nvcc`` into ``pccf_torch/_build/``, runs
it on ``chip_smoke.py``'s auction shapes and clouds (``AUCTION_CASES``, drawn
from ``--seed`` as that script draws them), and prints each phase's mean time
and count.  A phase's time is the leader thread's own: its work, or its wait
at the barrier that ends it.  Run from the root of a checkout:

    python3 tools/auction_phases.py [--seed 0] [--reps 5]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pccf_torch.kernels import _build, auction_emd  # noqa: E402

# (anchor in the source, phase that ends there, mark after the anchor)
CLUSTER = [
    ('cluster.sync();  // the lists, counts and assignments of the round before\n', 'A: barrier', True),
    ('    if (total == 0) break;  // the same on every thread of the cluster: the cloud is assigned\n', 'counts', True),
    ('      bidders[s] = at<int>(bases, r, lay.list)[s - first];\n    }\n    __syncthreads();\n', 'gather', True),
    ('    cluster.sync();  // every partial in its handler\n', 'sweep', False),
    ('    cluster.sync();  // every partial in its handler\n', 'B: barrier', True),
    ('    cluster.sync();  // every bid in its item\'s inbox\n', 'merge, bid', False),
    ('    cluster.sync();  // every bid in its item\'s inbox\n', 'C: barrier', True),
    ('    if (listed) {\n      publish();\n    } else {\n', 'resolve', False),
    ('      cluster.sync();  // the evictions visible to the compaction\n', 'D: barrier', True),
    ('      compact();\n', 'compaction', True),
]
TAIL = [
    ('  cluster.sync();  // the other blocks leave once the leader has read their memory\n', 'tail: gather', True),
    ('        take(__fsub_rn(-sqdist(b.x, b.y, b.z, it.x, it.y, it.z), it.w), j, best, best_j, second);\n      }\n',
     'tail: items', True),
    ('        tpart[warp] = make_float4(best, second, __int_as_float(best_j), '
     'best_j != INT_MAX ? titems[best_j].w : 0.f);\n',
     'tail: warp merge', True),
    ('    if (warp == 0) {\n      // lane w holds warp w', 'tail: barrier 1', False),
    ('      merge_lanes<true>(best, second, best_j, price, per);\n', 'tail: merge warps', True),
    ('      const bool won = bidder && tkeys[best_j] == key;\n      __syncwarp();\n', 'tail: bid, atomic', True),
    ('      if (lane == 0) tail_count = __popc(keep);\n', 'tail: resolve, list', True),
    ('    cur ^= 1;\n    __syncthreads();\n', 'tail: barrier 2', True),
]
PHASES = CLUSTER + TAIL


def marked_source() -> str:
    src = (ROOT / 'pccf_torch/csrc/auction_emd.cu').read_text()
    src = src.replace('namespace {\n\nconstexpr int kAuctionThreads', '__device__ unsigned long long g_ns[64];\n'
                      '__device__ unsigned long long g_count[64];\n'
                      '__device__ __forceinline__ unsigned long long now_ns() {\n'
                      '  unsigned long long t;\n'
                      '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n  return t;\n}\n'
                      'namespace {\n\nconstexpr int kAuctionThreads', 1)
    src = src.replace('  const float* p2 = x2 + cloud * m * 3;\n', '  const float* p2 = x2 + cloud * m * 3;\n'
                      '  unsigned long long mark_t = now_ns();\n'
                      '  const bool marks = tid == 0 && rank == 0 && cloud == 0;\n', 1)
    for i, (anchor, _, after) in enumerate(PHASES):
        if src.count(anchor) != 1:
            raise SystemExit(f'anchor not found once in auction_emd.cu: {anchor!r}')
        mark = (f'if (marks) {{ const unsigned long long t = now_ns(); atomicAdd(&g_ns[{i}], t - mark_t); '
                f'atomicAdd(&g_count[{i}], 1ull); mark_t = t; }}\n')
        src = src.replace(anchor, anchor + mark if after else mark + anchor)
    return src + '''
extern "C" int auction_phases_read(unsigned long long* ns, unsigned long long* count) {
  cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));
  cudaMemcpyFromSymbol(count, g_count, sizeof(g_count));
  unsigned long long zero[64] = {};
  cudaMemcpyToSymbol(g_ns, zero, sizeof(zero));
  return (int)cudaMemcpyToSymbol(g_count, zero, sizeof(zero));
}
'''


def build(src: str, name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / 'auction_tools'
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f'{name}.cu', out / f'{name}.so'
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, '-shared', '-I', str(_build.CSRC), '-o', str(so), str(cu)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f'nvcc failed for {name}:\n{done.stderr[-4000:]}')
    lib = ctypes.CDLL(str(so))
    lib.pccf_auction_emd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_float,
                                     ctypes.c_int, *[ctypes.c_void_p] * 6]
    lib.pccf_auction_plan.argtypes = [*[ctypes.c_int] * 4, ctypes.c_void_p]
    return lib


def launcher(lib: ctypes.CDLL, x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int):
    """A call of the library's auction on the clouds, and its outputs."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    k = auction_emd.bidder_cap(n, None)
    plan = (ctypes.c_int * len(auction_emd.Plan._fields))()
    lib.pccf_auction_plan(b, n, m, k, plan)
    p = auction_emd.Plan(*plan)
    dev = x1.device
    out = (torch.empty((b, n), device=dev), torch.empty((b, n), dtype=torch.int32, device=dev),
           torch.empty((b, n), dtype=torch.int32, device=dev), torch.empty((b, 2), dtype=torch.int32, device=dev))
    scratch = torch.empty(max(16, auction_emd.scratch_bytes(b, p)), dtype=torch.uint8, device=dev)

    def call():
        err = lib.pccf_auction_emd(x1.data_ptr(), x2.data_ptr(), b, n, m, k, eps, iters, *(t.data_ptr() for t in out),
                                   scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'pccf_auction_emd: CUDA error {err}')

    return call, out


def clouds(seed: int, dev: torch.device, cases=None):
    """chip_smoke.py's auction shapes (or ``cases``, each (B, N, M,
    'train' or 'eval')), contracts (eps, rounds at most) and clouds, in its
    order."""
    import chip_smoke

    rng = np.random.default_rng([seed, 19])
    for b, n, m, contract in cases or chip_smoke.AUCTION_CASES:
        x1 = torch.from_numpy(rng.random((b, n, 3)).astype(np.float32)).to(dev)
        x2 = torch.from_numpy(rng.random((b, m, 3)).astype(np.float32)).to(dev)
        yield (b, n, m, contract), chip_smoke.AUCTION_CONTRACTS[contract], x1, x2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--reps', type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('auction_phases: needs a CUDA card', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    lib = build(marked_source(), 'auction_phases')
    lib.auction_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')
    ns, count = (ctypes.c_uint64 * 64)(), (ctypes.c_uint64 * 64)()
    for (b, n, m, contract), (eps, iters), x1, x2 in clouds(args.seed, dev):
        call, out = launcher(lib, x1, x2, eps, iters)
        call()
        torch.cuda.synchronize()
        lib.auction_phases_read(ns, count)
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
        lib.auction_phases_read(ns, count)
        total = sum(ns[i] for i in range(len(PHASES))) / args.reps
        parts = '; '.join(f'{name} {ns[i] / max(count[i], 1):.0f} ns x {count[i] // args.reps}'
                          for i, (_, name, _) in enumerate(PHASES) if count[i])
        print(f'({b}, {n}, 3) x ({b}, {m}, 3) {contract}: rounds {out[3][0, 0].item()}, bids '
              f'{out[3][0, 1].item()} (cloud 0); {total / 1e3:.1f} us marked a call; {parts}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Atomics and stores on another block's shared memory, on the card.

One cluster of 16 blocks of 1024 threads: every thread of block r applies
a 64-bit max, a 32-bit add and (the first 256) a float4 store to slot
``tid % 256`` of block ``(tid + r) % 16`` (``cluster.map_shared_rank``),
the 64-bit max once through the mapped pointer (``atomicMax``) and once as
``red.shared::cluster.max.u64``; then, as a control, the same 64-bit max on
the block's own shared memory.  After a cluster barrier each block's slots
are compared with the values the operations must leave.  The auction
kernel (``csrc/auction_emd.cu``) relies only on what passes here.  Run from
the root of a checkout:

    python3 tools/dsmem_atomics.py
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pccf_torch.kernels import _build  # noqa: E402

C, THREADS, SLOTS = 16, 1024, 256
SOURCE = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void dsmem_kernel(int mode, unsigned long long* out64, int* out32, float* outf) {
  __shared__ unsigned long long keys[256];
  __shared__ int adds[256];
  __shared__ float4 stored[256];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), c = cluster.num_blocks(), tid = threadIdx.x;
  if (tid < 256) {
    keys[tid] = 0ull;
    adds[tid] = 0;
    stored[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster.sync();
  const unsigned far = (tid + rank) % c, dst = mode == 2 ? rank : far, slot = tid % 256;
  const unsigned long long v = ((unsigned long long)(rank * 4096 + tid) << 32) | (0xffffffffu - tid);
  if (mode == 0) {
    atomicMax(cluster.map_shared_rank(keys, dst) + slot, v);
  } else if (mode == 1) {
    unsigned local = (unsigned)__cvta_generic_to_shared(keys + slot), remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(dst));
    asm volatile("red.shared::cluster.max.u64 [%0], %1;" ::"r"(remote), "l"(v) : "memory");
  } else {
    atomicMax(keys + slot, v);
  }
  atomicAdd(cluster.map_shared_rank(adds, far) + slot, 1);
  if (tid < 256) cluster.map_shared_rank(stored, far)[tid] = make_float4((float)rank, (float)tid, 1.f, 2.f);
  cluster.sync();
  const long long b = blockIdx.x;
  if (tid < 256) {
    out64[b * 256 + tid] = keys[tid];
    out32[b * 256 + tid] = adds[tid];
    outf[(b * 256 + tid) * 2] = stored[tid].x;
    outf[(b * 256 + tid) * 2 + 1] = stored[tid].y;
  }
}

extern "C" int dsmem_run(int mode, void* out64, void* out32, void* outf) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 16;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaError_t err = cudaFuncSetAttribute(dsmem_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(1024);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dsmem_kernel, mode, (unsigned long long*)out64, (int*)out32, (float*)outf);
  return (int)(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
'''


def expected(mode: int):
    """What each (block, slot) must hold: the max of the 64-bit values sent
    there, the number of adds, the (rank, tid) of the float4 stored there."""
    key = np.zeros((C, SLOTS), np.uint64)
    adds = np.zeros((C, SLOTS), np.int64)
    stored = np.zeros((C, SLOTS, 2))
    for rank in range(C):
        tid = np.arange(THREADS)
        far, slot = (tid + rank) % C, tid % SLOTS
        v = ((rank * 4096 + tid).astype(np.uint64) << np.uint64(32)) | (0xFFFFFFFF - tid).astype(np.uint64)
        np.maximum.at(key, (np.full(THREADS, rank) if mode == 2 else far, slot), v)
        np.add.at(adds, (far, slot), 1)
        stored[far[:SLOTS], tid[:SLOTS]] = np.stack([np.full(SLOTS, rank), tid[:SLOTS]], -1)
    return key, adds, stored


def main() -> int:
    if not torch.cuda.is_available():
        print('dsmem_atomics: needs a CUDA card', file=sys.stderr)
        return 1
    out = _build.BUILD_DIR / 'auction_tools'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'dsmem_atomics.cu').write_text(SOURCE)
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, '-shared', '-o', str(out / 'dsmem_atomics.so'),
           str(out / 'dsmem_atomics.cu')]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        print(done.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(out / 'dsmem_atomics.so'))
    lib.dsmem_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')
    what = {0: '64-bit atomicMax through map_shared_rank', 1: 'red.shared::cluster.max.u64',
            2: '64-bit atomicMax on the block\'s own shared memory'}
    for mode in (0, 1, 2):
        o64 = torch.zeros(C * SLOTS, dtype=torch.int64, device='cuda')
        o32 = torch.zeros(C * SLOTS, dtype=torch.int32, device='cuda')
        of = torch.zeros(C * SLOTS * 2, dtype=torch.float32, device='cuda')
        err = lib.dsmem_run(mode, o64.data_ptr(), o32.data_ptr(), of.data_ptr())
        if err:
            print(f'{what[mode]}: CUDA error {err}')
            return 1
        key, adds, stored = expected(mode)
        got = o64.cpu().numpy().view(np.uint64).reshape(C, SLOTS)
        wrong = int((got != key).sum())
        print(f'{what[mode]}: {wrong} of {C * SLOTS} slots wrong; 32-bit atomicAdd through map_shared_rank: '
              f'{int((o32.cpu().numpy().reshape(C, SLOTS) != adds).sum())} wrong; float4 stores through '
              f'map_shared_rank: {int((of.cpu().numpy().reshape(C, SLOTS, 2) != stored).sum())} values wrong',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

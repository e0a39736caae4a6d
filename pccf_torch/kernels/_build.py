"""Build and load the hand-written CUDA kernels.

At first use on a CUDA tensor, ``nvcc`` compiles every ``pccf_torch/csrc/*.cu``
for Hopper (``sm_90a``), one process per source, all started together, and
links the objects into one shared library with a plain C interface, which
``ctypes`` loads.  The library lands in ``pccf_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited kernel
is rebuilt and an unchanged one is reused within a checkout.

Each C entry point enqueues its kernel(s) on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises on anything but 0, so a
launch the CUDA runtime refuses (too many threads, too much shared memory) never
passes silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / '_build'
ARCH = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMPILE_FLAGS = (*ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-lineinfo')

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry point -> argument types; every entry point takes the stream last
SIGNATURES: dict[str, tuple] = {
    'pccf_knn': (P, P, P, P, P, I, I, I, I, I, P),
    'pccf_graph_max_pool': (P, P, P, I, I, I, I, P),
    'pccf_pcgen_mix': (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, P),
    'pccf_gemm': (P, I, P, P, I, I, I, I, I, P),
    'pccf_tf32_split': (P, P, P, I, P),
    'pccf_layer_norm': (P, P, P, P, I, I, F, P),
    'pccf_attention': (P, I, P, P, I, P, I, I, I, I, I, I, P),
    'pccf_gather_neighbors': (P, P, P, I, I, I, I, P),
    'pccf_scatter_add_rows': (P, P, P, P, I, I, I, I, I, P),
    'pccf_scatter_add_rows_scratch': (I, I, I, I),
    'pccf_graph_max_pool_src': (P, P, P, P, I, I, I, I, P),
    'pccf_scatter_add_slots': (P, P, P, P, I, I, I, I, I, P),
    'pccf_graph_sum_pool': (P, P, P, I, I, I, I, P),
    'pccf_chamfer_match_cost': (P, P, I, I, I, F, F, P, P, P, P, P, P, P, P, P),
    'pccf_nn_distance': (P, P, I, I, I, P, P, P, P, P),
    'pccf_sinkhorn_cost': (P, P, I, I, I, F, F, F, I, P, P, P, P, P, P, P, P, P),
}

CUDA_ERROR_INVALID_VALUE = 1

build_seconds: float | None = None
# source name -> ptxas's register and spill report (-v), kept by a build(verbose=True) that compiled
ptxas_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built from pccf_torch/csrc on first use')


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob('*.cu'))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(' '.join(COMPILE_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libpccf_kernels_{h.hexdigest()[:16]}.so'


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless an up-to-date library exists; returns its
    path.  With ``verbose``, a build keeps ptxas's report in :data:`ptxas_logs`."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    work = BUILD_DIR / f'tmp-{os.getpid()}'
    work.mkdir(parents=True, exist_ok=True)
    nvcc, sources = _nvcc(), _sources()
    objects = [work / f'{src.stem}.o' for src in sources]
    extra = ['-Xptxas=-v'] if verbose else []
    t0 = time.perf_counter()
    procs: list[subprocess.Popen] = []
    try:
        for src, obj in zip(sources, objects):
            procs.append(subprocess.Popen([nvcc, *COMPILE_FLAGS, *extra, '-c', '-o', str(obj), str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f'{src.name} ({proc.returncode}):\n{err[-8000:]}')
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        tmp = work / out.name
        link = subprocess.run([nvcc, *ARCH, '-shared', '-o', str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({link.returncode}):\n{link.stderr[-8000:]}')
        if verbose:
            ptxas_logs.update((src.name, log) for src, log in zip(sources, logs))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def kernel_resources(log: str) -> list[tuple[str, int, int, int]]:
    """``(mangled kernel name, registers, spill store bytes, spill load
    bytes)`` for every entry function in a ptxas report."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r'Used (\d+) registers', line)) and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    dll = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return dll


def check(name: str, err: int, shapes: str) -> None:
    """Raise unless a C entry point returned 0.  The guard at the top of each
    entry point is the one statement of the shapes its kernel covers; it
    returns ``cudaErrorInvalidValue`` for any other, as the runtime does for a
    shared-memory request the card cannot meet."""
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f'{name}: the kernel does not cover {shapes} (cudaErrorInvalidValue)')
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch ({shapes})')


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor (run
    the plain version); any other device has neither and raises."""
    if t.is_cuda:
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError(f'no kernel or plain version for device {t.device}')


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Validate a tensor handed to a kernel: on CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')

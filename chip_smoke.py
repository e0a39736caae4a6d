"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels of ``pccf_torch`` from
``pccf_torch/csrc`` and holds each against its plain PyTorch version on the
card at every shape the main path gives it, and times both beside the least
time the card could take for the same work (``pccf_torch.kernels.roofline``)
and, where one PyTorch call computes the same function, that call.  Then it
drives the three parts of the main path with the flagship model (random
weights from ``--seed``, the composed configuration unmodified, graph
filtering on):

- serving: counterfactual requests through
  ``pccf_torch.serve.CounterfactualServer``, checked for shapes,
  finiteness, batch invariance and agreement with the same model on the CPU;
- stage-1 training: VQ-VAE steps through ``pccf_torch.train.Trainer``
  (batch 8, 2048 points, AdamW at lr 0.004) on a fixed batch of synthetic
  clouds under each reconstruction objective (ChamferEMD, the flagship's,
  then Chamfer and ChamferSinkhorn, each + embedding loss), checked for
  finite and falling losses and for the launches of that objective's loss
  kernel alone, and one step at batch 2 and 512 points against the same step
  on the CPU under each; then the entry point
  ``pccf_torch.train.autoencoder.train_autoencoder`` under Chamfer and
  ChamferSinkhorn for 2 epochs of 16 clouds (validation, the codebook hook
  after every epoch, the final test);
- stage-2 training: ``pccf_torch.train.w_autoencoder.train_w_autoencoder``
  for one epoch on codes derived from 64 clouds (derived dataset, two steps
  of batch 32, validation, final test, merge back), then W-autoencoder steps
  on one derived batch (finite losses, falling MSE) and a validation pass
  over two batches, whose W-nets run their transformer stacks through the
  ``wformer`` kernels; one step at a small width against the CPU; and the
  counterfactual route with the fused CVAE gate failing, against the CPU.

Each path must have launched every kernel it runs (launch counts set to 0
just before the path and read just after).

kNN is checked and timed at serving's batch 1, 5 and 16, at stage 1's 8 and
at stage 2's 32; at batch 1 the kernel splits each cloud's candidates across
blocks (its lists held equal to the unsplit ones); the fused PCGen at batch 1
and 16.

Before the kernel table it prints a line for every shape at which the
stacks' device kernels run (``pccf_gemm`` and ``pccf_attention``, recorded
from the W-encoder, W-decoder and the batch-16 and batch-1 CVAE chains):
the check against the float64 product or attention, the time per launch,
the plain version's, the one-call PyTorch yardstick's and the bound; then the
weight split that feeds the GEMM (``pccf_tf32_split``) on the real weights of
the W-encoder, the W-decoder and the CVAE pack, bit-exact against its plain
version.

    python3 chip_smoke.py [--seed 0]

The row scatter and the EMD are also held bit-equal across two calls, the
row scatter bit-equal to its plain version run on the CPU (both add in
ascending edge order), and one EMD call's device launches are read from a
trace: 19 pair sweeps.

It also prints the compiler's registers and spills of the row scatter's and
the EMD's kernels on one line, a
``torch.profiler`` table of one batch-16 request, of one training step of
each stage (stage 1 under each objective, with its device busy time and the
device time of the row scatter's and the EMD's launches, their count checked
against the wrapper calls) and of one validation batch, the
warm request latency at batch 1 and 16, the step time, samples/s and peak
memory of both stages, the seconds of each stage-1 entry-point run and the
validation time per batch, the numbers PERF.md quotes.

Kernel times are medians over samples of many back-to-back calls between
one pair of CUDA events, queued behind a spin kernel so that the host's
dispatch stays out of them (``time_ms``).

Prints the card's name and power limit, one JSON line with the kernels, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing
no result, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPS = 10  # timed samples per kernel and version; the median is reported
SAMPLE_MS = 2.0  # the least device time of the back-to-back calls of one sample
MAX_CALLS = 500  # back-to-back calls of one sample at most
SPIN_CYCLES_PER_MS = 2e6  # the spin kernel's clock cycles per ms (SM clock at most ~2 GHz)

# tolerances, each with its reason
# distances in 3xTF32 (C > 16) or fp32 FMA, summed in another order than the
# plain version's: near-ties at the k-th slot may swap
KNN_SET_AGREEMENT = 0.999
# the kernel rounds the component weights and their products' inputs to fp16
# (the join, h before each later layer; the layer-0 residual reads the fp16
# join) where the TPU kernel rounds to bf16, sums in fp32.  It reads ~3e-4;
# 1e-2 is the bound every PCGen kernel of the port has met, bf16 included
# (~4e-3).  RECON_REL_L2 is the check that bf16 failed, and the card tests
# hold the kernel to fp16's precision (2e-3)
PCGEN_REL_L2 = 1e-2
CVAE_REL_L2 = 1e-3  # 3xTF32 products: about fp32 rounding, through 8 transformer layers
CODE_AGREEMENT = 0.99  # VQ argmin on card vs CPU
# the stacks' GEMM against the float64 product and epilogue: 3xTF32 drops the
# small-small term (~2^-22 of each product), the tensor cores sum each 32-wide
# k tile and the tiles add in fp32; one TF32 product alone misses by ~3e-4
GEMM_REL_L2 = 5e-6
ATTENTION_REL_L2 = 1e-5  # the same products, and the online softmax rescales its fp32 sums
RECON_REL_L2 = 1e-2  # the decode runs the fp16 PCGen kernel on the card
BATCH_INVARIANCE = 1e-4  # rel. max difference of a request alone vs inside a batch
# |diff| / max |plain|: the slot scatter's fp32 atomics add in an order that
# changes from run to run, and the plain version's reduction on the card may
# take its own order; the row scatter adds in ascending edge order, the order
# of the plain version on the CPU, which it equals bit for bit
SCATTER_REL_MAX = 1e-5
SUM_POOL_REL_MAX = 1e-5  # the kernel adds the k rows in slot order, the plain reduction in its own
EMD_COST_RTOL = 1e-4  # exp2 of the folded level and the row and column sums in another order than the plain version's
EMD_GRAD_REL_L2 = 1e-3  # the same, through nine levels of remaining mass
# Sinkhorn: exp recomputed in every sweep (expf, as the plain version's) and
# the sums over the pairs taken in another order, through twelve updates of
# each scaling; its Chamfer minima and argmins, like nn_distance's, bit-exact
# (the same float32 squared distances, the lowest index on ties)
SINKHORN_COST_RTOL = 1e-4
SINKHORN_GRAD_REL_L2 = 1e-3
# one training step on the card against the same step on the CPU: atomics
# reorder the slot scatter's sums, EMD recomputes its exps, cuBLAS and the CPU add
# GEMM terms in other orders, and a kNN neighbour or VQ code at a near-tie may
# differ between the two
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_REL_L2 = 1e-2  # per parameter
STEP_UPDATE_REL_L2 = 1e-2  # the AdamW update of all trained parameters together
# one stage-2 step at a small width, card against CPU: no discrete choice
# feeds the loss, so the losses and gradients differ by GEMM summation order
# only; the quantisation accuracy counts argmin choices, which a near-tie may
# flip; AdamW's first step moves each element by about lr * sign(g)
W_STEP_LOSS_RTOL = 1e-4
W_STEP_ACCURACY_ATOL = 0.01  # 1% of the code slots
W_STEP_GRAD_REL_L2 = 1e-3  # per parameter
# attention key biases shift every score of a row by the same amount, so
# their gradient is zero but for rounding and its sign is noise: left out of
# the per-parameter gradient, update and clipper comparisons
ZERO_GRADIENT_SUFFIX = 'key.bias'

KERNEL_INFO = {
    'knn': ('pccf_torch/csrc/knn.cu', 'pccf/kernels/pallas_knn.py:183'),
    'graph_max_pool': ('pccf_torch/csrc/graph_max_pool.cu', 'pccf/kernels/pallas_gather.py:218'),
    'pcgen_mix': ('pccf_torch/csrc/pcgen_mix.cu', 'pccf/kernels/pallas_pcgen.py:133'),
    'cvae_cf': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_cvae.py:203'),
    'gather_neighbors': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:309'),
    'scatter_add_rows': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:182'),
    'graph_max_pool_src': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:121'),
    'scatter_add_slots': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:200'),
    'graph_sum_pool': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:256'),
    'chamfer_match_cost': ('pccf_torch/csrc/emd.cu', 'pccf/kernels/pallas_emd.py:218'),
    'wformer_encoder': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_wformer.py:335'),
    'wformer_decoder': ('pccf_torch/csrc/wformer.cu', 'pccf/kernels/pallas_wformer.py:365'),
    'nn_distance': ('pccf_torch/csrc/nn_distance.cu', 'pccf/kernels/pallas_chamfer.py:78'),
    'sinkhorn_cost': ('pccf_torch/csrc/sinkhorn.cu', 'pccf/kernels/pallas_sinkhorn.py:163'),
}
SERVING_KERNELS = ('knn', 'graph_max_pool', 'pcgen_mix', 'cvae_cf', 'gather_neighbors')
# every stage-1 step launches these, and the kernel of its reconstruction loss
TRAINING_KERNELS = ('knn', 'gather_neighbors', 'scatter_add_rows', 'graph_max_pool_src', 'scatter_add_slots',
                    'graph_sum_pool')
LOSS_KERNELS = {'ChamferEMD': 'chamfer_match_cost', 'Chamfer': 'nn_distance', 'ChamferSinkhorn': 'sinkhorn_cost'}
ENTRY_TRAIN, ENTRY_TEST, ENTRY_EPOCHS = 16, 8, 2  # the stage-1 entry point's clouds and epochs
STAGE2_KERNELS = ('knn', 'graph_max_pool', 'wformer_encoder', 'wformer_decoder')
TRAIN_BATCH, WARM_STEPS, TIMED_STEPS = 8, 2, 10
STEPS_PER_EPOCH = 100  # the timed steps stay in epoch 0: lr 0.004 (stage 1), 0.0014 / 6 (stage 2, warmup)
VALIDATION_REPS = 3


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm((got - want).double()) / (torch.linalg.norm(want.double()) + 1e-30))


def time_ms(fn, reps: int) -> float:
    """Median device time of one call over ``reps`` samples.  A sample is as
    many back-to-back calls as span ``SAMPLE_MS`` (at most ``MAX_CALLS``)
    between one pair of CUDA events, divided by their count; a spin kernel
    queued before the first event lasts as long as the host takes to enqueue
    them, so the events see device time and not the host's dispatch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    calls = int(min(MAX_CALLS, max(1, math.ceil(SAMPLE_MS / max(start.elapsed_time(end), 1e-3)))))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int(2 * calls * host_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_events(prof) -> list[tuple[str, float]]:
    """``(name, us)`` of every device activity of a ``torch.profiler`` trace,
    in the order they started."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its namespace, return type and arguments."""
    m = re.search(r'(\w+(?:<[^()]*>)?)\(', name)
    return m.group(1) if m else name


EMD_PAIR_SWEEPS = 19  # rows P1 of -4^7, then per level columns P2 and rows P3 (+ P1 of the next level)
# the two port kernels whose device time the stage-1 steps sum: the pattern of
# their device kernels' names, and how many of those one wrapper call launches
# (the scatter: partition, lists, gather; the EMD: 2 fills, the sweeps, the
# per-sample sum, which sinkhorn.cu launches too)
DEVICE_NAMES = {'scatter_add_rows': (r'scatter_(partition|lists|gather)_kernel', 3),
                'chamfer_match_cost': (r'emd_(fill|rows|cols)_kernel|sample_sum_kernel', EMD_PAIR_SWEEPS + 3)}


class LaunchLog:
    """Stands in for the kernel library while a path runs: forwards every
    entry point and records its name and arguments (host pointer arrays read
    out as lists)."""

    def __init__(self, lib) -> None:
        self.lib, self.calls = lib, []

    def __getattr__(self, name: str):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, [list(a) if isinstance(a, ctypes.Array) else a for a in args]))
            return fn(*args)

        return call


def launch_shapes(build, run) -> list[tuple]:
    """The distinct shapes at which ``run`` launches ``pccf_gemm`` (``('gemm',
    M, N, K, groups, bias, gelu, res_rows or 0, out aliases res)``) and
    ``pccf_attention`` (``('attention', B, T, T_kv, heads, head_dim)``), in
    order of first launch."""
    real = build.lib
    log = LaunchLog(real())
    build.lib = lambda: log
    try:
        run()
        torch.cuda.synchronize()
    finally:
        build.lib = real
    shapes = []
    for name, args in log.calls:
        if name == 'pccf_gemm':
            _, groups, ops, res, m, n, k, res_rows, gelu, _ = args
            key = ('gemm', m, n, k, groups, all(ops[2 * groups: 3 * groups]), bool(gelu), res_rows if res else 0,
                   res == ops[3 * groups])
        elif name == 'pccf_attention':
            key = ('attention', *args[7:12])
        else:
            continue
        if key not in shapes:
            shapes.append(key)
    return shapes


def knn_check(x: torch.Tensor, k: int, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(neighbour-set agreement, max |sorted kernel distances − sorted plain
    distances|), the distances recomputed in float64 from the indices."""
    agree = (got.long().unsqueeze(-1) == want.long().unsqueeze(-2)).any(-1).float().mean().item()
    xd = x.double()

    def dists(idx):
        nb = torch.gather(xd, 1, idx.long().reshape(x.shape[0], -1, 1).expand(-1, -1, x.shape[2]))
        d = ((nb.reshape(*idx.shape, -1) - xd[:, :, None, :]) ** 2).sum(-1)
        return torch.sort(d, dim=-1).values

    return agree, float((dists(got) - dists(want)).abs().max())


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


@torch.no_grad()
def library_stack(pack: list[dict], n_heads: int, decoder: bool) -> torch.nn.Module:
    """The same stack as PyTorch's own ``nn.TransformerEncoder`` /
    ``nn.TransformerDecoder`` (pre-norm, exact GELU, eps 1e-6, no dropout),
    every layer's FF zero-padded to the widest: the yardstick timed as
    ``library_ms``, which the port never calls."""
    from torch import nn

    d = pack[0]['wo'].shape[0]
    f_max = max(p['w1'].shape[0] for p in pack)
    dev = pack[0]['wo'].device
    layer_cls = nn.TransformerDecoderLayer if decoder else nn.TransformerEncoderLayer
    layer = layer_cls(d, n_heads, f_max, dropout=0.0, activation='gelu', layer_norm_eps=1e-6, batch_first=True,
                      norm_first=True)
    stack = nn.TransformerDecoder(layer, len(pack)) if decoder else nn.TransformerEncoder(
        layer, len(pack), enable_nested_tensor=False)

    def load_attn(attn, p, prefix):
        attn.in_proj_weight.copy_(torch.cat([p[f'w{prefix}{n}'] for n in 'qkv']))
        attn.in_proj_bias.copy_(torch.cat([p[f'b{prefix}{n}'] for n in 'qkv']))
        attn.out_proj.weight.copy_(p[f'w{prefix}o'])
        attn.out_proj.bias.copy_(p[f'b{prefix}o'])

    def load_norm(norm, p, name):
        norm.weight.copy_(p[f'{name}_w'])
        norm.bias.copy_(p[f'{name}_b'])

    stack = stack.to(dev)
    for mod, p in zip(stack.layers, pack):
        load_attn(mod.self_attn, p, '')
        load_norm(mod.norm1, p, 'ln1')
        if decoder:
            load_attn(mod.multihead_attn, p, 'x')
            load_norm(mod.norm2, p, 'lnx')
            load_norm(mod.norm3, p, 'ln2')
        else:
            load_norm(mod.norm2, p, 'ln2')
        f = p['w1'].shape[0]
        for lin in (mod.linear1, mod.linear2):
            lin.weight.zero_()
        mod.linear1.bias.zero_()
        mod.linear1.weight[:f].copy_(p['w1'])
        mod.linear1.bias[:f].copy_(p['b1'])
        mod.linear2.weight[:, :f].copy_(p['w2'])
        mod.linear2.bias.copy_(p['b2'])
    return stack.eval()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from pccf_torch import config as pc
    from pccf_torch.config import SliceConfig
    from pccf_torch.data import synthetic
    from pccf_torch.data.processed import WDatasetWithLogits
    from pccf_torch.data.structures import Inputs, Targets, WInputs, WTargets
    from pccf_torch.kernels import _build, api, chamfer, cvae, emd, gather, knn, ops, pcgen, roofline, sinkhorn, wformer
    from pccf_torch.models import WAETrainModule, build_vqvae, build_w_autoencoder
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import gumbel_uniform, init_from_seed
    from pccf_torch.serve import CounterfactualServer
    from pccf_torch.train import Loader, Test, Trainer, get_autoencoder_loss, get_w_autoencoder_loss
    from pccf_torch.train.autoencoder import train_autoencoder
    from pccf_torch.train.hooks import DEAD_ENTRY
    from pccf_torch.train.w_autoencoder import build_w_train_model, train_w_autoencoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            failures.append(what)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ''
    check(bool(card), 'nvidia-smi reads the card')
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    print(f'kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds or 0.0:.1f} s)', flush=True)
    resources = []
    for source, name in (('gather_scatter.cu', 'scatter_add_rows'), ('emd.cu', 'chamfer_match_cost')):
        for mangled, regs, stores, loads in _build.kernel_resources(_build.ptxas_logs.get(source, '')):
            if re.search(DEVICE_NAMES[name][0], mangled):
                filt = subprocess.run(['c++filt'], input=mangled, capture_output=True, text=True) \
                    if shutil.which('c++filt') else None
                kernel = short_kernel_name(filt.stdout.strip() + '(') if filt and filt.returncode == 0 else mangled
                resources.append(f'{source} {kernel}: {regs} registers, spill stores / loads {stores} / {loads} bytes')
    print('registers and spills (nvcc -Xptxas -v), the row scatter and EMD kernels: '
          + ('; '.join(resources) if resources else 'none read: the library was built before this run'), flush=True)

    cfg = SliceConfig()
    rng = np.random.default_rng(args.seed)
    vqvae = build_vqvae(cfg)
    classifier = build_classifier(cfg)
    init_from_seed(vqvae, args.seed)
    init_from_seed(classifier, args.seed + 1)
    vqvae = vqvae.to(dev).eval()
    classifier = classifier.to(dev).eval()
    b, n = 16, cfg.data.n_input_points
    kernels: dict[str, dict] = {}

    def bound(work: roofline.Work) -> dict:
        ms, by = roofline.bound_ms(work)
        return {'bound_ms': ms, 'bound_by': by}

    # ---- each kernel against its plain version at the flagship shapes ----
    with torch.inference_mode():
        # every (C, k) the main path gives kNN: the encoder's k=25 and the
        # classifier's k=20 at C = 3, 64, 128 (C=64 twice per model), and
        # graph filtering's k=4 on the decoded cloud; at serving's batch 1, 5
        # and 16 (the candidate split acts at 1), at stage 1's 8 and at stage
        # 2's 32, the derived dataset's chunk; a split batch must get the
        # neighbours it gets with the candidates unsplit.
        # no single PyTorch call computes kNN indices (cdist, then topk) or a
        # max over gathered rows (indexing, then amax): library_ms is null
        batches = (b, cfg.w_autoencoder.train.batch_size)
        knn_errs, knn_ms = [], {}
        for bb in (1, 5, TRAIN_BATCH, *batches):
            for c in (3, 64, 128):
                for k in (25, 20, 4) if c == 3 else (25, 20):
                    x = torch.from_numpy(rng.standard_normal((bb, n, c)).astype(np.float32)).to(dev)
                    got, want = knn.knn_cuda(x, k), knn.plain(x, k)
                    torch.cuda.synchronize()
                    agree, err = knn_check(x, k, got, want)
                    knn_errs.append(err)
                    self_first = bool((got[..., 0] == torch.arange(n, device=dev)).float().mean() > 0.999)
                    splits = knn.splits(bb, n, torch.cuda.get_device_properties(dev).multi_processor_count)
                    unsplit = splits == 1 or torch.equal(got, knn.knn_cuda(x, k, n_splits=1))
                    row = knn_ms[bb, c, k] = (time_ms(lambda: knn.knn_cuda(x, k), REPS),
                                              time_ms(lambda: knn.plain(x, k), REPS), bound(roofline.knn_work(x, k)))
                    # knn.splits' choice beside half and twice as many splits
                    others = {s: time_ms(lambda: knn.knn_cuda(x, k, n_splits=s), REPS)
                              for s in (splits // 2, 2 * splits) if 1 <= s <= min(knn.MAX_SPLITS, -(-n // knn.TILE))}
                    check(agree >= KNN_SET_AGREEMENT and self_first and unsplit,
                          f'knn B={bb} C={c} k={k}, {splits} split(s): neighbour-set agreement {agree:.6f}, self '
                          f'first, max |kth-distance diff| {err:.2e}, equal to the unsplit lists {unsplit}; '
                          f'{row[0]:.4f} ms (plain {row[1]:.3f} ms, bound {row[2]["bound_ms"]:.4f} ms, '
                          f'{row[2]["bound_by"]}); '
                          + ', '.join(f'{v:.4f} ms in {s} splits' for s, v in others.items()))
        head = knn_ms[b, 128, 25]
        kernels['knn'] = {'max_abs_err': max(knn_errs), 'ms': head[0], 'plain_ms': head[1], **head[2],
                          'library_ms': None, 'shape': '(16, 2048, 128) k=25'}
        print('knn ms by (B, C, k): ' + json.dumps({f'{bb},{c},{k}': round(v[0], 4) for (bb, c, k), v in
                                                    knn_ms.items()}), flush=True)

        # every (F, k) the main path gives max-pool: F = 64, 128, 256 at the
        # encoder's k=25 and the classifier's k=20, at both batches
        pool_errs, pool_ms = [], {}
        for bb in batches:
            for f in (64, 128, 256):
                for k in (25, 20):
                    x = torch.from_numpy(rng.standard_normal((bb, n, f)).astype(np.float32)).to(dev)
                    idx = knn.knn_cuda(torch.from_numpy(rng.standard_normal((bb, n, 8)).astype(np.float32)).to(dev), k)
                    err = float((gather.graph_max_pool_cuda(x, idx) - gather.plain(x, idx)).abs().max())
                    pool_errs.append(err)
                    row = pool_ms[bb, f, k] = (time_ms(lambda: gather.graph_max_pool_cuda(x, idx), REPS),
                                               time_ms(lambda: gather.plain(x, idx), REPS),
                                               bound(roofline.pool_work(x, idx)))
                    check(err == 0.0, f'graph_max_pool B={bb} F={f} k={k}: bit-exact (max |diff| {err}); '
                          f'{row[0]:.3f} ms (plain {row[1]:.3f} ms, bound {row[2]["bound_ms"]:.4f} ms)')
        head = pool_ms[b, 256, 25]
        kernels['graph_max_pool'] = {'max_abs_err': max(pool_errs), 'ms': head[0], 'plain_ms': head[1], **head[2],
                                     'library_ms': None, 'shape': '(16, 2048, 256) k=25'}

        # the fused PCGen at serving's batch 1 and 16 (the headline)
        dec = vqvae.decoder
        pack = dec.pack()
        pcgen_errs, pcgen_rows = [], {}
        for bb in (1, b):
            m = torch.relu(torch.from_numpy(rng.standard_normal((bb, n, 64)).astype(np.float32))).to(dev)
            w = torch.from_numpy(rng.standard_normal((bb, cfg.autoencoder.w_dim)).astype(np.float32)).to(dev)
            run_k = functools.partial(pcgen.pcgen_mix_cuda, m, w, pack, tau=dec.tau, act_slope=0.0)
            run_p = functools.partial(pcgen.plain, m, w, pack, tau=dec.tau, act_slope=0.0)
            got, want = run_k(), run_p()
            r = rel_l2(got, want)
            pcgen_errs.append(float((got - want).abs().max()))
            work = roofline.pcgen_work(m, w, pack)
            row = pcgen_rows[bb] = {'rel_l2': r, 'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
                                    **bound(work)}
            check(r <= PCGEN_REL_L2 and bool(torch.isfinite(got).all()),
                  f'pcgen_mix B={bb}: rel L2 {r:.3e} <= {PCGEN_REL_L2}; {row["ms"]:.4f} ms (plain '
                  f'{row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.4f} ms, {row["bound_by"]})')
        # the chain and the fused PCGen have no single PyTorch call either
        kernels['pcgen_mix'] = {'max_abs_err': max(pcgen_errs), **pcgen_rows[b], 'library_ms': None,
                                'shape': '(16, 2048, 64) -> (16, 2048, 3), G=8, 1024-1024-256-16'}

        wae = vqvae.w_autoencoder
        cpack = cvae.pack_cvae_cf(wae)
        tokens = torch.from_numpy(rng.standard_normal((b, wae.n_codes, wae.embedding_dim)).astype(np.float32)).to(dev)
        probs = torch.softmax(torch.from_numpy(rng.standard_normal((b, cfg.data.n_classes)).astype(np.float32)), -1)
        probs = probs.to(dev)
        run_k = lambda: cvae.cvae_cf_cuda(tokens, probs, cpack)  # noqa: E731
        run_p = lambda: cvae.plain(tokens, probs, cpack)  # noqa: E731
        got, want = run_k(), run_p()
        r = rel_l2(got, want)
        check(r <= CVAE_REL_L2 and bool(torch.isfinite(got).all()), f'cvae_cf: rel L2 {r:.3e} <= {CVAE_REL_L2}')
        kernels['cvae_cf'] = {'max_abs_err': float((got - want).abs().max()), 'rel_l2': r,
                              'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
                              **bound(roofline.cvae_work(tokens, probs, cpack)), 'library_ms': None,
                              'shape': '(16, 256, 4), d=512, 8 heads, 2+2+4 layers'}

        # ---- the training path's kernels at its shapes, batch 8 ----------
        bt = TRAIN_BATCH

        def graph(k: int, c: int = 8) -> torch.Tensor:
            return knn.knn_cuda(torch.from_numpy(rng.standard_normal((bt, n, c)).astype(np.float32)).to(dev), k)

        def randn(*shape: int) -> torch.Tensor:
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

        def timed(name: str, shape: str, run_k, run_p, err: float, ok: bool, what: str, work: roofline.Work,
                  run_lib=None) -> None:
            """Time the kernel, its plain version and, where one exists, the
            single PyTorch call that computes the same function."""
            row = {'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS), **bound(work),
                   'library_ms': time_ms(run_lib, REPS) if run_lib is not None else None}
            lib = f', library {row["library_ms"]:.3f}' if run_lib is not None else ''
            check(ok, f'{name} {shape}: {what}; {row["ms"]:.3f} ms (plain {row["plain_ms"]:.3f}{lib}, bound '
                      f'{row["bound_ms"]:.4f} ms, {row["bound_by"]})')
            entry = kernels.setdefault(name, {'max_abs_err': 0.0, 'shapes': {}})
            entry['max_abs_err'] = max(entry['max_abs_err'], err)
            entry['shapes'][shape] = row
            entry.update(row, shape=shape)  # the last (largest) shape is the headline

        def index_add_rows(g: torch.Tensor, idx: torch.Tensor):
            """``index_add_`` over the flattened rows, the yardstick of the row
            scatter (its index and expanded source made beforehand)."""
            bb, m, c = g.shape
            rows = (idx.long() + n * torch.arange(bb, device=dev)[:, None, None]).reshape(-1)
            src = g[:, :, None, :].expand(bb, m, idx.shape[-1], c).reshape(-1, c)
            return lambda: torch.zeros((bb * n, c), device=dev).index_add_(0, rows, src)

        # pool with slot and its slot scatter at every encoder width, k=25
        idx25 = graph(25)
        for f in (64, 128, 256):
            x = randn(bt, n, f)
            out, slots = gather.graph_max_pool_src_cuda(x, idx25)
            want, want_slots = ops.graph_max_pool_slots(x, idx25)
            exact = torch.equal(out, want) and torch.equal(slots, want_slots)
            eval_equal = torch.equal(out, gather.graph_max_pool_cuda(x, idx25))
            timed('graph_max_pool_src', f'({bt}, {n}, {f}) k=25', lambda: gather.graph_max_pool_src_cuda(x, idx25),
                  lambda: ops.graph_max_pool_slots(x, idx25), float((out - want).abs().max()), exact and eval_equal,
                  f'max and slots bit-exact {exact}, bit-equal to graph_max_pool {eval_equal}',
                  roofline.pool_work(x, idx25, slots=True))
            g = randn(bt, n, f)
            got, want = gather.scatter_add_slots_cuda(g, idx25, slots, n), ops.scatter_add_slots(g, idx25, slots, n)
            r = rel_max(got, want)
            timed('scatter_add_slots', f'({bt}, {n}, {f}) k=25', lambda: gather.scatter_add_slots_cuda(g, idx25, slots, n),
                  lambda: ops.scatter_add_slots(g, idx25, slots, n), float((got - want).abs().max()),
                  r <= SCATTER_REL_MAX, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}',
                  roofline.scatter_slots_work(g, idx25, slots, n))

        def row_scatter_exact(got: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> tuple[bool, bool]:
            """(the kernel's rows equal the plain version's on a CPU copy, which
            adds in the kernel's ascending edge order; a second call equals the
            first)."""
            cpu = ops.scatter_add_rows(g.cpu(), idx.cpu(), n)
            return torch.equal(got.cpu(), cpu), torch.equal(got, gather.scatter_add_rows_cuda(g, idx, n))

        # sum-pool of [u, u^2] and its row scatter at every encoder width, k=25
        for f2 in (128, 256, 512):
            x = randn(bt, n, f2)
            got, want = gather.graph_sum_pool_cuda(x, idx25), ops.graph_sum_pool(x, idx25)
            r = rel_max(got, want)
            timed('graph_sum_pool', f'({bt}, {n}, {f2}) k=25', lambda: gather.graph_sum_pool_cuda(x, idx25),
                  lambda: ops.graph_sum_pool(x, idx25), float((got - want).abs().max()), r <= SUM_POOL_REL_MAX,
                  f'rel max diff {r:.2e} <= {SUM_POOL_REL_MAX}', roofline.pool_work(x, idx25))
            got, want = gather.scatter_add_rows_cuda(x, idx25, n), ops.scatter_add_rows(x, idx25, n)
            r, exact, same = rel_max(got, want), *row_scatter_exact(got, x, idx25)
            timed('scatter_add_rows', f'({bt}, {n}, {f2}) k=25', lambda: gather.scatter_add_rows_cuda(x, idx25, n),
                  lambda: ops.scatter_add_rows(x, idx25, n), float((got - want).abs().max()),
                  r <= SCATTER_REL_MAX and exact and same, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}, bit-equal '
                  f'to the plain version on the CPU {exact}, the same on a second call {same}',
                  roofline.scatter_rows_work(x, idx25, n), index_add_rows(x, idx25))
        # graph filtering's gather on the decoded cloud, k=4: serving (batch
        # 16) and training (batch 8, with its scatter: N*4 rows of one
        # neighbour); the yardstick is one advanced-indexing call
        for bb in (b, bt):
            cloud = torch.from_numpy(rng.standard_normal((bb, n, 3)).astype(np.float32)).to(dev)
            idx4 = knn.knn_cuda(cloud, 4)
            exact = torch.equal(gather.gather_neighbors_cuda(cloud, idx4), ops.gather_neighbors(cloud, idx4))
            rows4, batch_rows = idx4.long(), torch.arange(bb, device=dev)[:, None, None]
            timed('gather_neighbors', f'({bb}, {n}, 3) k=4', lambda: gather.gather_neighbors_cuda(cloud, idx4),
                  lambda: ops.gather_neighbors(cloud, idx4), 0.0 if exact else float('inf'), exact,
                  f'bit-exact {exact}', roofline.gather_work(cloud, idx4), lambda: cloud[batch_rows, rows4])
        g = randn(bt, n * 4, 3)
        flat = idx4.reshape(bt, n * 4, 1)
        got, want = gather.scatter_add_rows_cuda(g, flat, n), ops.scatter_add_rows(g, flat, n)
        r, exact, same = rel_max(got, want), *row_scatter_exact(got, g, flat)
        timed('scatter_add_rows', f'({bt}, {n}*4, 3) k=1', lambda: gather.scatter_add_rows_cuda(g, flat, n),
              lambda: ops.scatter_add_rows(g, flat, n), float((got - want).abs().max()),
              r <= SCATTER_REL_MAX and exact and same, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}, bit-equal to '
              f'the plain version on the CPU {exact}, the same on a second call {same}',
              roofline.scatter_rows_work(g, flat, n), index_add_rows(g, flat))
        headline = f'({bt}, {n}, 512) k=25'
        kernels['scatter_add_rows'].update(kernels['scatter_add_rows']['shapes'][headline], shape=headline)
        # the ChamferEMD loss on a decoded cloud against its reference
        x1 = torch.from_numpy(synthetic.batch(args.seed, bt, n)).to(dev)
        x2 = (x1 + 0.05 * randn(bt, n, 3)).contiguous()
        got, want = emd.chamfer_match_cost_cuda(x1, x2), emd.plain(x1, x2)
        cost_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        g1, g2 = rel_l2(got[1], want[1]), rel_l2(got[2], want[2])
        nn_exact = all(torch.equal(a, w) for a, w in zip(got[3:], want[3:]))
        same = all(torch.equal(a, w) for a, w in zip(got, emd.chamfer_match_cost_cuda(x1, x2)))
        timed('chamfer_match_cost', f'({bt}, {n}, 3) x ({bt}, {n}, 3)', lambda: emd.chamfer_match_cost_cuda(x1, x2),
              lambda: emd.plain(x1, x2), float((got[0] - want[0]).abs().max()),
              cost_err <= EMD_COST_RTOL and max(g1, g2) <= EMD_GRAD_REL_L2 and nn_exact and same,
              f'cost rel err {cost_err:.2e} <= {EMD_COST_RTOL}, grad rel L2 {g1:.2e} / {g2:.2e} <= '
              f'{EMD_GRAD_REL_L2}, Chamfer min/argmin exact {nn_exact}, the same on a second call {same}',
              roofline.emd_work(x1, x2))
        # what one call runs on the device, from a trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            emd.chamfer_match_cost_cuda(x1, x2)
            torch.cuda.synchronize()
        sequence = [short_kernel_name(name) for name, _ in device_events(prof)]
        sweeps = sum(1 for name in sequence if re.match(r'emd_(rows|cols)_kernel', name))
        check(sweeps == EMD_PAIR_SWEEPS, f'chamfer_match_cost: {sweeps} pair sweeps a call == {EMD_PAIR_SWEEPS}; '
                                         f'device launches in order: {", ".join(sequence)}')
        # the Chamfer and ChamferSinkhorn losses at the shapes their paths
        # give them, the headline (8, 2048, 3)^2 last: a decoded cloud
        # against its reference, a smaller batch, and a rectangular pair for
        # the marginal multipliers; no single PyTorch call computes either
        for bb, n1, n2, seed in ((2, 512, 512, 20), (bt, n, n // 2, 21), (bt, n, n, 22)):
            y1 = torch.from_numpy(synthetic.batch(args.seed + seed, bb, n1)).to(dev)
            y2 = (torch.from_numpy(synthetic.batch(args.seed + seed + 1, bb, n2)).to(dev)
                  + 0.05 * randn(bb, n2, 3)).contiguous()
            shape = f'({bb}, {n1}, 3) x ({bb}, {n2}, 3)'
            got, want = chamfer.nn_distance_cuda(y1, y2), chamfer.plain(y1, y2)
            exact = all(torch.equal(a, w) for a, w in zip(got, want))
            timed('nn_distance', shape, lambda: chamfer.nn_distance_cuda(y1, y2), lambda: chamfer.plain(y1, y2),
                  0.0 if exact else float('inf'), exact, f'minima and argmins bit-exact {exact}',
                  roofline.nn_distance_work(y1, y2))
            got, want = sinkhorn.sinkhorn_cost_cuda(y1, y2), sinkhorn.plain(y1, y2)
            cost_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
            g1, g2 = rel_l2(got[1], want[1]), rel_l2(got[2], want[2])
            exact = all(torch.equal(a, w) for a, w in zip(got[3:], want[3:]))
            timed('sinkhorn_cost', shape, lambda: sinkhorn.sinkhorn_cost_cuda(y1, y2), lambda: sinkhorn.plain(y1, y2),
                  float((got[0] - want[0]).abs().max()),
                  cost_err <= SINKHORN_COST_RTOL and max(g1, g2) <= SINKHORN_GRAD_REL_L2 and exact,
                  f'cost rel err {cost_err:.2e} <= {SINKHORN_COST_RTOL}, grad rel L2 {g1:.2e} / {g2:.2e} <= '
                  f'{SINKHORN_GRAD_REL_L2}, Chamfer min/argmin exact {exact}', roofline.sinkhorn_work(y1, y2))

        # ---- the stage-2 stacks at the flagship shapes, batch 32 ----------
        # the W-encoder and the posterior (2 layers, FF 1024) and the
        # W-decoder (4 layers, FF 1024, 1024, 1024, 512), packed from a
        # W-autoencoder's live weights as the eval forward packs them
        wae = build_w_autoencoder(cfg)
        init_from_seed(wae, args.seed + 6)
        wae = wae.to(dev)
        bw, t, d = cfg.w_autoencoder.train.batch_size, wae.n_codes, wae.decoder.proj_dim
        stacks = [('wformer_encoder', 'W-encoder', wae.encoder), ('wformer_encoder', 'posterior', wae.z2_posterior),
                  ('wformer_decoder', 'W-decoder', wae.decoder)]
        stack_runs = {}
        for name, net_name, net in reversed(stacks):  # the W-encoder last: the headline
            decoder = name == 'wformer_decoder'
            heads = net.n_heads
            x = randn(bw, t, d)
            ff = ', '.join(str(layer.dense_0.out_features) for layer in net.layers)
            shape = f'{net_name} ({bw}, {t}, {d}), {heads} heads, FF {ff}'
            if decoder:
                memory = randn(bw, t, d)
                spack = wformer.pack_decoder(net.layers)
                run_k = functools.partial(wformer.wformer_decoder_cuda, x, memory, spack, heads)
                run_p = lambda: wformer.plain_decoder(x, memory, spack, heads)  # noqa: E731
                lib_stack = library_stack(spack, heads, True)
                run_l = lambda: lib_stack(x, memory)  # noqa: E731
                work = roofline.decoder_stack_work(x, memory, spack)
            else:
                spack = wformer.pack_encoder(net.layers)
                run_k = functools.partial(wformer.wformer_encoder_cuda, x, spack, heads)
                run_p = lambda: wformer.plain_encoder(x, spack, heads)  # noqa: E731
                lib_stack = library_stack(spack, heads, False)
                run_l = lambda: lib_stack(x)  # noqa: E731
                work = roofline.encoder_stack_work(x, spack)
            got, want, lib_out = run_k(), run_p(), run_l()
            r, r_lib = rel_l2(got, want), rel_l2(lib_out, want)
            timed(name, shape, run_k, run_p, float((got - want).abs().max()),
                  r <= CVAE_REL_L2 and r_lib <= CVAE_REL_L2 and bool(torch.isfinite(got).all()),
                  f'rel L2 {r:.3e} <= {CVAE_REL_L2} (the library stack against the plain version {r_lib:.3e}); '
                  f'{work.ops / 1e9:.1f} GFLOP', work, run_l)
            stack_runs[net_name] = run_k

        # ---- the stacks' device kernels, one line per shape they launch ---
        # recorded from the headline W-encoder and W-decoder (batch 32) and
        # the CVAE chain at serving's batch 16 and 1
        stack_runs['CVAE b16'] = functools.partial(cvae.cvae_cf_cuda, tokens, probs, cpack)
        stack_runs['CVAE b1'] = functools.partial(cvae.cvae_cf_cuda, tokens[:1].contiguous(), probs[:1].contiguous(),
                                                  cpack)
        shapes: dict[tuple, list[str]] = {}
        for who in ('W-encoder', 'W-decoder', 'CVAE b16', 'CVAE b1'):
            for key in launch_shapes(_build, stack_runs[who]):
                shapes.setdefault(key, []).append(who)
        launch_ms: dict[tuple, float] = {}
        for key, who in shapes.items():
            if key[0] == 'gemm':
                _, m, nn, k, groups, has_bias, gelu, res_rows, alias = key
                a = randn(m, k)
                wts = [randn(nn, k) * k ** -0.5 for _ in range(groups)]
                biases = [randn(nn) if has_bias else None for _ in range(groups)]
                res = randn(res_rows, nn) if res_rows else None
                st = wformer.Stacks(1, m, k, dev)
                want = [a.double() @ w.double().T + (bb.double() if has_bias else 0.0) for w, bb in zip(wts, biases)]
                if gelu:
                    want = [ops.gelu_exact(x) for x in want]
                if res is not None:
                    want = [x + res.double().repeat(m // res_rows, 1) for x in want]
                outs = [res.clone()] if alias else [torch.empty(m, nn, device=dev) for _ in wts]
                st.gemm(a, wts, biases, outs, outs[0] if alias else res, res_rows, gelu)
                r = max(rel_l2(o, x) for o, x in zip(outs, want))
                if alias:
                    outs = [res]

                def plain(a=a, wts=wts, biases=biases, res=res, gelu=gelu, m=m):
                    ys = [torch.nn.functional.linear(a, w, bb) for w, bb in zip(wts, biases)]
                    ys = [ops.gelu_exact(y) for y in ys] if gelu else ys
                    return [y + res.repeat(m // res.shape[0], 1) for y in ys] if res is not None else ys

                w_cat, b_cat = torch.cat(wts), torch.cat(biases) if has_bias else None
                row = (time_ms(functools.partial(st.gemm, a, wts, biases, outs, res, res_rows, gelu), REPS),
                       time_ms(plain, REPS),
                       time_ms(functools.partial(torch.nn.functional.linear, a, w_cat, b_cat), REPS),
                       bound(roofline.gemm_work(m, nn, k, groups, has_bias, res_rows)))
                epilogue = ' + '.join(e for e, on in (('bias', has_bias), ('GELU', gelu), (
                    f'res[row % {res_rows}]' if res_rows and res_rows != m else 'res', res_rows),
                    ('in place', alias)) if on) or 'none'
                what = f'pccf_gemm (M, N, K) = ({m}, {nn}, {k}){f" x {groups} groups" if groups > 1 else ""}, ' \
                       f'{epilogue} [{", ".join(who)}]: rel L2 vs float64 {r:.2e} <= {GEMM_REL_L2}'
                ok = r <= GEMM_REL_L2
            else:
                _, bb, tq, tk, heads, hd = key
                dd = heads * hd
                q, k_, v_ = randn(bb * tq, dd), randn(bb * tk, dd), randn(bb * tk, dd)
                out = torch.empty(bb * tq, dd, device=dev)
                st = wformer.Stacks(bb, tq, dd, dev)
                st.attend(q, k_, v_, out, heads)
                want = ops.attention(q.double().view(bb, tq, dd), k_.double().view(bb, tk, dd),
                                     v_.double().view(bb, tk, dd), heads)
                r = rel_l2(out.view(bb, tq, dd), want)
                q4, k4, v4 = (x.view(bb, -1, heads, hd).transpose(1, 2) for x in (q, k_, v_))
                row = (time_ms(functools.partial(st.attend, q, k_, v_, out, heads), REPS),
                       time_ms(functools.partial(ops.attention, q.view(bb, tq, dd), k_.view(bb, tk, dd),
                                                 v_.view(bb, tk, dd), heads), REPS),
                       time_ms(functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4), REPS),
                       bound(roofline.attention_work(bb, tq, tk, heads, hd)))
                what = f'pccf_attention (B, T, T_kv) = ({bb}, {tq}, {tk}), {heads} heads of {hd} ' \
                       f'[{", ".join(who)}]: rel L2 vs float64 {r:.2e} <= {ATTENTION_REL_L2}'
                ok = r <= ATTENTION_REL_L2
            launch_ms[key] = row[0]
            check(ok, f'{what}; {row[0]:.4f} ms a launch (plain {row[1]:.4f}, library {row[2]:.4f}, bound '
                      f'{row[3]["bound_ms"]:.4f} ms ({row[3]["bound_by"]}), share {row[3]["bound_ms"] / row[0]:.1%})')

        # the weight split that feeds the GEMM, on the real weights of the
        # W-encoder, the W-decoder and the CVAE pack; no PyTorch call splits
        for who, ws in (('W-encoder', wformer.stack_weights(wformer.pack_encoder(wae.encoder.layers))),
                        ('W-decoder', wformer.stack_weights(wformer.pack_decoder(wae.decoder.layers))),
                        ('CVAE pack', cpack.cuda_operands()['weights'])):
            small = wformer.split_small(ws)
            exact = all(torch.equal(small[w.data_ptr()], wformer.tf32_split(w)[1]) for w in ws)
            work = roofline.split_work(ws)
            row = (time_ms(functools.partial(wformer.split_small, ws), REPS),
                   time_ms(lambda ws=ws: [wformer.tf32_split(w)[1] for w in ws], REPS), bound(work))
            check(exact, f'pccf_tf32_split, the {len(ws)} matrices of the {who} ({work.bytes / 8e6:.2f} M '
                         f'elements): small parts bit-exact {exact}; {row[0]:.4f} ms a launch (plain {row[1]:.4f}, '
                         f'bound {row[2]["bound_ms"]:.4f} ms ({row[2]["bound_by"]}), '
                         f'share {row[2]["bound_ms"] / row[0]:.1%})')

    # ---- the main path, serving: a server answering requests -------------
    server = CounterfactualServer(vqvae, classifier, buckets=(1, 2, 4, 8, 16), seed=args.seed)
    clouds = (rng.standard_normal((22, n, 3)) / 2).astype(np.float32)
    requests = [
        (clouds[:1], np.asarray([1]), np.asarray([11])),
        (clouds[1:6], np.asarray([0, 1, 0, 1, 1]), np.asarray([21, 22, 3, 24, 25])),
        # the first request again, at position 7 of a full batch
        (np.concatenate([clouds[6:13], clouds[:1], clouds[13:21]]),
         np.arange(16) % 2 | (np.arange(16) == 7), np.concatenate([np.arange(100, 107), [11], np.arange(107, 115)])),
    ]
    api.reset_launch_counts()
    outs, req_ms = [], []
    for cl, tdim, seeds in requests:
        t0 = time.perf_counter()
        outs.append(server.counterfactual(cl, tdim, sampling_seed=seeds))
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = api.launch_counts()
    for (cl, _, _), out in zip(requests, outs):
        check(out.shape == (cl.shape[0], cfg.data.n_target_points, 3) and bool(np.isfinite(out).all()),
              f'request of {cl.shape[0]}: output {out.shape} finite')
    diff = float(np.abs(outs[0][0] - outs[2][7]).max() / (np.sqrt(np.mean(outs[0] ** 2)) + 1e-12))
    check(diff <= BATCH_INVARIANCE, f'request alone vs inside a batch of 16: rel max diff {diff:.2e}')
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f'{name}: {launches[name]} launches on the serving path')
    print(f'request ms (batch 1, 5, 16; host clock incl. copies): {[round(v, 3) for v in req_ms]}', flush=True)
    for i in (0, 2):  # warm requests, batch 1 and batch 16: device time by kernel, then latency
        cl, tdim, seeds = requests[i]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server.counterfactual(cl, tdim, sampling_seed=seeds)
            torch.cuda.synchronize()
        print(f'profile of one batch-{cl.shape[0]} request:', flush=True)
        print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=12, max_name_column_width=50), flush=True)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            server.counterfactual(cl, tdim, sampling_seed=seeds)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        print(f'warm request batch {cl.shape[0]}: median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms '
              f'over {REPS} (host clock incl. copies)', flush=True)

    # ---- card vs CPU on a batch of 2 --------------------------------------
    pair = torch.from_numpy(clouds[1:3])
    samp = server.initial_sampling(np.asarray([1, 2])).cpu()
    tdim = torch.tensor([1, 0])

    def run(vq, cls, device):
        with torch.inference_mode():
            cloud = pair.to(device)
            logits = cls(Inputs(cloud=cloud))
            out = vq.generate_counterfactual(Inputs(cloud=cloud, initial_sampling=samp.to(device)), logits,
                                             tdim.to(device))
            return logits.cpu(), out.idx.cpu(), out.recon.cpu()

    gpu = run(vqvae, classifier, dev)
    cpu_vqvae = copy.deepcopy(vqvae).cpu()
    cpu_vqvae.prepack()  # the folded weights are not module state: fold again on the CPU
    cpu = run(cpu_vqvae, copy.deepcopy(classifier).cpu(), torch.device('cpu'))
    lerr = float((gpu[0] - cpu[0]).abs().max() / (cpu[0].abs().max() + 1e-12))
    check(lerr <= 1e-3, f'card vs CPU logits: rel max diff {lerr:.2e}')
    agree = float((gpu[1] == cpu[1]).float().mean())
    check(agree >= CODE_AGREEMENT, f'card vs CPU code agreement {agree:.4f} >= {CODE_AGREEMENT}')
    same = (gpu[1] == cpu[1]).all(dim=1)
    check(bool(same.any()), f'card vs CPU: {int(same.sum())} of 2 samples with all codes equal')
    if same.any():
        r = rel_l2(gpu[2][same], cpu[2][same])
        check(r <= RECON_REL_L2, f'card vs CPU recon rel L2 {r:.3e} <= {RECON_REL_L2}')

    # ---- the main path, training: stage-1 steps of the flagship VQ-VAE ---
    # under the flagship's ChamferEMD objective, then under Chamfer and
    # ChamferSinkhorn, each from the same weights on the same fixed batch
    tcfg = cfg.autoencoder.train
    model = build_vqvae(cfg)
    init_from_seed(model, args.seed + 2)
    base_state = copy.deepcopy(model.state_dict())
    del model
    batch = torch.from_numpy(synthetic.batch(args.seed + 3, TRAIN_BATCH, n)).to(dev)
    inputs, targets = Inputs(batch), Targets(batch)
    train_launches = dict.fromkeys(KERNEL_INFO, 0)  # ChamferEMD's steps
    objective_launches = dict.fromkeys(KERNEL_INFO, 0)  # the steps and the entry point of the other two

    def objective_cfg(recon_loss: str, **autoencoder) -> SliceConfig:
        return dataclasses.replace(cfg, autoencoder=dataclasses.replace(
            cfg.autoencoder, train=dataclasses.replace(tcfg, recon_loss=recon_loss), **autoencoder))

    def stage1_steps(recon_loss: str, totals: dict[str, int]) -> None:
        """Warm and timed steps: finite and falling losses, step time,
        samples/s, peak memory, a profile, and in every step the launches of
        the stage-1 kernels and of this objective's loss kernel alone."""
        label = f'stage-1 {recon_loss}'
        model = build_vqvae(cfg)
        model.load_state_dict(base_state)
        model = model.to(dev)
        trainer = Trainer(model, get_autoencoder_loss(objective_cfg(recon_loss)), tcfg, STEPS_PER_EPOCH,
                          seed=args.seed)
        losses, step_ms, step_launches = [], [], []
        for step in range(WARM_STEPS + TIMED_STEPS):
            if step == WARM_STEPS:
                torch.cuda.reset_peak_memory_stats()
                held_gib = torch.cuda.memory_allocated() / 2**30
            api.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = trainer.run_step(inputs, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = api.launch_counts()
            step_launches.append(counts)
            for name, count in counts.items():
                totals[name] += count
            losses.append({k: float(v) for k, v in metrics.items()})
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(all(np.isfinite(list(m.values())).all() for m in losses),
              f'{label}: every loss finite over {len(losses)} steps')
        first, last = losses[0]['Loss'], losses[-1]['Loss']
        check(last < first, f'{label}: loss {first:.4f} at step 1 -> {last:.4f} at step {len(losses)} on the same '
                            f'batch')
        print(f'{label} losses per step: ' + json.dumps([{k: round(v, 5) for k, v in m.items()} for m in losses]),
              flush=True)
        expected = {**dict.fromkeys(TRAINING_KERNELS, True),
                    **{name: name == LOSS_KERNELS[recon_loss] for name in LOSS_KERNELS.values()}}
        for name, launched in expected.items():
            per_step = [c[name] for c in step_launches]
            check(min(per_step) > 0 if launched else max(per_step) == 0,
                  f'{name}: launches per {label} step {per_step}')
        q1, med, q3 = np.percentile(step_ms[WARM_STEPS:], [25, 50, 75])
        print(f'{label} step (batch {TRAIN_BATCH}, {n} points): median {med:.3f} ms, quartiles {q1:.3f} / '
              f'{q3:.3f} ms over {TIMED_STEPS} (host clock, synchronised); {TRAIN_BATCH / med * 1e3:.1f} samples/s; '
              f'peak memory {peak_gib:.3f} GiB (max_memory_allocated; {held_gib:.3f} GiB held before the timed '
              f'steps)', flush=True)
        api.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run_step(inputs, targets)
            torch.cuda.synchronize()
        calls = api.launch_counts()
        print(f'profile of one {label} step:', flush=True)
        print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=25, max_name_column_width=60),
              flush=True)
        events = device_events(prof)
        parts = []
        for name, (pattern, per_call) in DEVICE_NAMES.items():
            if name in LOSS_KERNELS.values() and name != LOSS_KERNELS[recon_loss]:
                continue  # the loss kernels' sources share sample_sum_kernel
            times = [us for ev, us in events if re.search(pattern, ev)]
            check(len(times) == per_call * calls[name] > 0,
                  f'{label} step: {len(times)} device launches of {name}\'s kernels == {per_call} x {calls[name]} '
                  f'calls')
            parts.append(f'{name} kernels {len(times)} launches, {sum(times) / 1e3:.4f} ms')
        print(f'{label} step, device: busy {sum(us for _, us in events) / 1e3:.3f} ms in {len(events)} activities; '
              + '; '.join(parts), flush=True)

    stage1_steps('ChamferEMD', train_launches)
    for recon_loss in ('Chamfer', 'ChamferSinkhorn'):
        stage1_steps(recon_loss, objective_launches)

    # ---- one training step on the card against the CPU, batch 2 x 512 ----
    pts = 512
    gen = torch.Generator().manual_seed(args.seed + 4)
    small = torch.from_numpy(synthetic.batch(args.seed + 5, 2, pts))
    sampling = torch.randn((2, pts, cfg.autoencoder.decoder.sample_dim), generator=gen)
    noise = gumbel_uniform((2, pts, cfg.autoencoder.decoder.n_components), gen, torch.device('cpu'))

    def one_step(device: torch.device, recon_loss: str):
        m = build_vqvae(cfg)
        m.load_state_dict(base_state)
        m = m.to(device)
        tr = Trainer(m, get_autoencoder_loss(objective_cfg(recon_loss)), tcfg, STEPS_PER_EPOCH)
        before = {k: p.detach().clone() for k, p in m.named_parameters()}
        cl = small.to(device)
        out = tr.run_step(Inputs(cl, initial_sampling=sampling.to(device)), Targets(cl), noise.to(device))
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}
        updates = {k: (p.detach() - before[k]).cpu() for k, p in m.named_parameters()}
        return {k: float(v) for k, v in out.items()}, grads, updates

    for recon_loss in LOSS_KERNELS:
        label = f'card vs CPU {recon_loss} step'
        t0 = time.perf_counter()
        gpu_step, cpu_step = one_step(dev, recon_loss), one_step(torch.device('cpu'), recon_loss)
        print(f'card and CPU {recon_loss} step at batch 2 x {pts}: {time.perf_counter() - t0:.1f} s', flush=True)
        for name, value in cpu_step[0].items():
            r = abs(gpu_step[0][name] - value) / abs(value)
            check(r <= STEP_LOSS_RTOL, f'{label}: {name} {gpu_step[0][name]:.6f} vs {value:.6f}, rel {r:.2e}')
        check(set(gpu_step[1]) == set(cpu_step[1]) and not any(k.startswith('w_autoencoder.') for k in gpu_step[1]),
              f'{label}: the same {len(cpu_step[1])} parameters have gradients, none of the frozen inner CVAE')
        grad_errs = {k: rel_l2(gpu_step[1][k], v) for k, v in cpu_step[1].items()}
        worst = max(grad_errs, key=grad_errs.get)
        check(grad_errs[worst] <= STEP_GRAD_REL_L2,
              f'{label}: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}), '
              f'median {float(np.median(list(grad_errs.values()))):.2e}')
        upd = rel_l2(torch.cat([gpu_step[2][k].flatten() for k in cpu_step[1]]),
                     torch.cat([cpu_step[2][k].flatten() for k in cpu_step[1]]))
        frozen_still = all(not bool(v.any()) for k, v in gpu_step[2].items() if k.startswith('w_autoencoder.'))
        check(upd <= STEP_UPDATE_REL_L2 and frozen_still,
              f'{label}: AdamW update rel L2 {upd:.2e} <= {STEP_UPDATE_REL_L2}; frozen inner CVAE unmoved '
              f'{frozen_still}')

    # ---- the main path, the stage-1 entry point under Chamfer and ----------
    # ChamferSinkhorn: the flagship width, its depth cut to 2 epochs over 16
    # training and 8 test clouds, the codebook hook after every epoch
    e_train = torch.from_numpy(synthetic.batch(args.seed + 13, ENTRY_TRAIN, n))
    e_test = torch.from_numpy(synthetic.batch(args.seed + 14, ENTRY_TEST, n))
    for recon_loss in ('Chamfer', 'ChamferSinkhorn'):
        label = f'stage-1 entry point ({recon_loss})'
        e_cfg = objective_cfg(recon_loss, diagnose_every=1)
        e_model = build_vqvae(e_cfg)
        e_model.load_state_dict(base_state)
        api.reset_launch_counts()
        t0 = time.perf_counter()
        result = train_autoencoder(e_cfg, e_model, e_train, e_test, n_epochs=ENTRY_EPOCHS, seed=args.seed,
                                   device=dev)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        counts = api.launch_counts()
        for name, count in counts.items():
            objective_launches[name] += count
        e_trainer, hook, e_test_metrics = result['trainer'], result['codebook_hook'], result['test']
        steps = ENTRY_TRAIN // tcfg.batch_size * ENTRY_EPOCHS
        check(e_trainer.step == steps and e_trainer.epoch == ENTRY_EPOCHS
              and len(e_trainer.validation_log) == ENTRY_EPOCHS
              and all(np.isfinite(list(v.values())).all() for v in e_trainer.validation_log),
              f'{label}, {ENTRY_EPOCHS} epochs of {ENTRY_TRAIN} clouds in {entry_s:.1f} s: {e_trainer.step} steps, '
              f'validation {json.dumps(e_trainer.validation_log)}')
        usage = hook.last_usage
        dead = torch.from_numpy(usage == 0).to(dev)
        check(bool((usage.sum(axis=1) == ENTRY_TRAIN).all()) and bool((e_model.codebook[dead] == DEAD_ENTRY).all()),
              f'{label}: the codebook hook ran, every slot has a used entry ({int((usage > 0).sum())} of '
              f'{usage.size} entries used), the {int(dead.sum())} unused ones at {DEAD_ENTRY} after the final epoch')
        check(np.isfinite(list(e_test_metrics.values())).all() and ('EMD' in e_test_metrics),
              f'{label}: final test {json.dumps(e_test_metrics)}')
        launched = (LOSS_KERNELS[recon_loss], 'pcgen_mix', 'knn') + (
            ('chamfer_match_cost',) if recon_loss == 'Chamfer' else ())  # the EMD the final test attaches
        for name in launched:
            check(counts[name] > 0, f'{name}: {counts[name]} launches in the {label}')
        print(f'launches, {label}: {json.dumps(counts)}', flush=True)

    # ---- the main path, stage 2: the entry point for one epoch ------------
    wcfg = cfg.w_autoencoder.train
    w_train = torch.from_numpy(synthetic.batch(args.seed + 7, 2 * bw, n))
    w_test = torch.from_numpy(synthetic.batch(args.seed + 8, 2 * bw, n))
    stage2_launches = dict.fromkeys(KERNEL_INFO, 0)

    def add_launches(what: str) -> dict[str, int]:
        """Read the counts of one run of the stage-2 path into its total."""
        counts = api.launch_counts()
        for name, count in counts.items():
            stage2_launches[name] += count
        print(f'launches, {what}: {json.dumps(counts)}', flush=True)
        return counts

    api.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_w_autoencoder(cfg, copy.deepcopy(vqvae), classifier, w_train, w_test, n_epochs=1, seed=args.seed,
                                 device=dev)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = add_launches('stage-2 entry point')
    w_trainer = result['trainer']
    check(w_trainer.step == 2 and len(w_trainer.validation_log) == 1 and bool(np.isfinite(result['loss'])),
          f'stage 2 entry point, 1 epoch of {2 * bw} clouds in {entry_s:.1f} s: {w_trainer.step} steps, '
          f'validation {json.dumps(w_trainer.validation_log)}, test loss {result["loss"]:.4f}')
    for name in STAGE2_KERNELS:
        check(counts[name] > 0, f'{name}: {counts[name]} launches in the stage-2 entry point')
    # a validation pass and the final test, two batches each: the W-encoder
    # and the posterior are encoder stacks, the W-decoder a decoder stack
    check((counts['wformer_encoder'], counts['wformer_decoder']) == (8, 4),
          f'stage 2 entry point: wformer launches {counts["wformer_encoder"]} / {counts["wformer_decoder"]} == 8 / 4')

    # ---- stage-2 steps on one derived batch of 32 -------------------------
    api.reset_launch_counts()
    w_loader = Loader(WDatasetWithLogits(w_train.to(dev), vqvae, classifier), bw, args.seed)
    w_batches = list(w_loader.batches())
    w_model = build_w_train_model(cfg, vqvae, seed=args.seed + 9)
    w_loss = get_w_autoencoder_loss(wcfg)
    trainer = Trainer(w_model, w_loss, wcfg, STEPS_PER_EPOCH, seed=args.seed)
    winputs, wtargets = w_batches[0]
    w_losses, w_step_ms = [], []
    for step in range(WARM_STEPS + TIMED_STEPS):
        if step == WARM_STEPS:
            torch.cuda.reset_peak_memory_stats()
            w_held_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        metrics = trainer.run_step(winputs, wtargets)
        torch.cuda.synchronize()
        w_step_ms.append((time.perf_counter() - t0) * 1e3)
        w_losses.append({k: float(v) for k, v in metrics.items()})
    w_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    add_launches(f'deriving {len(w_batches)} batches and {len(w_losses)} stage-2 steps')
    check(all(np.isfinite(list(m.values())).all() for m in w_losses),
          f'stage 2: every loss finite over {len(w_losses)} steps')
    first, last = w_losses[0]['MSE'], w_losses[-1]['MSE']
    check(last < first, f'stage 2: MSE {first:.4f} at step 1 -> {last:.4f} at step {len(w_losses)} on the same batch')
    print('stage-2 losses per step: ' + json.dumps([{k: round(v, 6) for k, v in m.items()} for m in w_losses]),
          flush=True)
    q1, med, q3 = np.percentile(w_step_ms[WARM_STEPS:], [25, 50, 75])
    print(f'stage-2 step (batch {bw}, {t} codes, d {d}): median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms '
          f'over {TIMED_STEPS} (host clock, synchronised); {bw / med * 1e3:.1f} samples/s; '
          f'peak memory {w_peak_gib:.3f} GiB (max_memory_allocated; {w_held_gib:.3f} GiB held before the timed '
          f'steps, earlier phases included)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_step(winputs, wtargets)
        torch.cuda.synchronize()
    print('profile of one stage-2 step:', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=20, max_name_column_width=60), flush=True)

    # ---- the stage-2 validation pass over two derived batches -------------
    validation = Test(w_model, w_loader, w_loss, 'Validation', seed=args.seed)
    api.reset_launch_counts()
    val_metrics = validation(trainer.epoch)
    torch.cuda.synchronize()
    counts = add_launches('one validation pass')
    check((counts['wformer_encoder'], counts['wformer_decoder']) == (2 * len(w_batches), len(w_batches))
          and all(np.isfinite(list(val_metrics.values()))),
          f'validation over {len(w_batches)} batches: wformer launches {counts["wformer_encoder"]} / '
          f'{counts["wformer_decoder"]} (2 and 1 per batch), metrics {json.dumps(val_metrics)}')
    val_ms, fwd_ms = [], []
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for _ in range(VALIDATION_REPS):
        t0 = time.perf_counter()
        validation(trainer.epoch)
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t0) * 1e3 / len(w_batches))
        with torch.no_grad():
            w_model.eval()
            t0 = time.perf_counter()
            for wi, wt in w_batches:
                w_loss.loss_and_metrics(w_model(wi, None, gen).replace(model_epoch=float(trainer.epoch)), wt)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3 / len(w_batches))
    print(f'validation ms per batch of {bw}: median {np.median(val_ms):.3f} over {VALIDATION_REPS} passes '
          f'(derived dataset included: VQ-VAE encoder and classifier on 2048-point clouds), '
          f'{np.median(fwd_ms):.3f} for the W-autoencoder and its loss alone (host clock, synchronised)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, torch.no_grad():
        w_loss.loss_and_metrics(w_model(winputs, None, gen).replace(model_epoch=float(trainer.epoch)), wtargets)
        torch.cuda.synchronize()
    print('profile of one validation batch (W-autoencoder and loss, eval):', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=15, max_name_column_width=60), flush=True)

    # ---- one stage-2 step at a small width on the card against the CPU ---
    tnet = pc.TransformerNetConfig
    small_cfg = SliceConfig(
        autoencoder=pc.AutoEncoderConfig(book_size=8, w_dim=512),
        w_autoencoder=pc.WAutoEncoderConfig(
            z1_dim=4, z2_dim=4, w_encoder=tnet(128, 2, (256,)), w_decoder=tnet(128, 2, (128, 256)),
            conditional_w_encoder=tnet(128, 2, (128,)), train=pc.WAutoEncoderTrainConfig(batch_size=4)))
    s_t, s_e = small_cfg.autoencoder.n_codes, small_cfg.autoencoder.embedding_dim
    s_model = WAETrainModule(build_w_autoencoder(small_cfg), small_cfg.autoencoder.book_size)
    init_from_seed(s_model, args.seed + 10)
    s_state = copy.deepcopy(s_model.state_dict())
    s_rng = np.random.default_rng(args.seed + 11)

    def s_randn(*shape: int) -> torch.Tensor:
        return torch.from_numpy(s_rng.standard_normal(shape).astype(np.float32))

    s_in = WInputs(s_randn(4, s_t * s_e), 2 * s_randn(4, cfg.data.n_classes))
    s_idx = torch.from_numpy(s_rng.integers(0, 8, (4, s_t)))
    s_tg = WTargets(s_randn(4, s_t * s_e), torch.eye(8)[s_idx], s_in.logits)
    s_eps = (s_randn(4, s_t, 4), s_randn(4, s_t, 4))
    s_tcfg = small_cfg.w_autoencoder.train

    def w_step(device: torch.device):
        m = WAETrainModule(build_w_autoencoder(small_cfg), small_cfg.autoencoder.book_size)
        m.load_state_dict(s_state)
        m = m.to(device)
        tr = Trainer(m, get_w_autoencoder_loss(s_tcfg), s_tcfg, STEPS_PER_EPOCH)
        before = {k: p.detach().clone() for k, p in m.named_parameters()}
        out = tr.run_step(WInputs(s_in.w_q.to(device), s_in.logits.to(device)),
                          WTargets(s_tg.w_e.to(device), s_tg.one_hot_idx.to(device), s_tg.logits.to(device)),
                          tuple(e.to(device) for e in s_eps))
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}
        updates = {k: (p.detach() - before[k]).cpu() for k, p in m.named_parameters()}
        return {k: float(v) for k, v in out.items()}, grads, updates, tr.grad_op.state()

    gpu_w, cpu_w = w_step(dev), w_step(torch.device('cpu'))
    for name, value in cpu_w[0].items():
        if name == 'Quantisation Accuracy':
            ok, r = abs(gpu_w[0][name] - value) <= W_STEP_ACCURACY_ATOL, abs(gpu_w[0][name] - value)
        else:
            r = abs(gpu_w[0][name] - value) / max(abs(value), 1e-30)
            ok = r <= W_STEP_LOSS_RTOL
        check(ok, f'card vs CPU stage-2 step: {name} {gpu_w[0][name]:.6g} vs {value:.6g}, diff {r:.2e}')
    compared = [k for k in cpu_w[1] if not k.endswith(ZERO_GRADIENT_SUFFIX)]
    grad_errs = {k: rel_l2(gpu_w[1][k], cpu_w[1][k]) for k in compared}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= W_STEP_GRAD_REL_L2,
          f'card vs CPU stage-2 step: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}), '
          f'median {float(np.median(list(grad_errs.values()))):.2e}, over {len(compared)} of {len(cpu_w[1])}')
    upd = rel_l2(torch.cat([gpu_w[2][k].flatten() for k in compared]),
                 torch.cat([cpu_w[2][k].flatten() for k in compared]))
    clip_err = max(abs(gpu_w[3][k][0] - cpu_w[3][k][0]) / max(abs(cpu_w[3][k][0]), 1e-30) for k in compared)
    check(upd <= STEP_UPDATE_REL_L2 and clip_err <= W_STEP_LOSS_RTOL,
          f'card vs CPU stage-2 step: AdamW update rel L2 {upd:.2e} <= {STEP_UPDATE_REL_L2}; clipper norm EMA '
          f'max rel diff {clip_err:.2e}')

    # ---- the counterfactual route with the fused chain's gate failing -----
    # a W-encoder 256 wide (4 heads of 64) beside 512-wide nets: the three
    # nets run one by one, each stack through its wformer kernel
    u_cfg = dataclasses.replace(cfg, w_autoencoder=dataclasses.replace(cfg.w_autoencoder,
                                                                       w_encoder=tnet(256, 4)))
    u_wae = build_w_autoencoder(u_cfg)
    init_from_seed(u_wae, args.seed + 12)
    u_wae.eval()
    u_in = WInputs(torch.from_numpy(rng.standard_normal((2, cfg.autoencoder.w_dim)).astype(np.float32)),
                   torch.from_numpy(2 * rng.standard_normal((2, cfg.data.n_classes)).astype(np.float32)))
    u_book = vqvae.codebook.detach().cpu()
    with torch.inference_mode():
        want = u_wae.generate_counterfactual(u_in, u_book, 1)
        u_wae = u_wae.to(dev)
        api.reset_launch_counts()
        got = u_wae.generate_counterfactual(WInputs(u_in.w_q.to(dev), u_in.logits.to(dev)), u_book.to(dev), 1)
        counts = api.launch_counts()  # a check of another route: not added to the main path's launches
    r = rel_l2(got.w_recon.cpu(), want.w_recon)
    agree = float((got.idx.cpu() == want.idx).float().mean())
    check(not u_wae.fused_ok() and (counts['wformer_encoder'], counts['wformer_decoder'], counts['cvae_cf']) == (2, 1, 0)
          and r <= CVAE_REL_L2 and agree >= CODE_AGREEMENT,
          f'unfused counterfactual route: wformer launches {counts["wformer_encoder"]} / {counts["wformer_decoder"]}, '
          f'cvae_cf {counts["cvae_cf"]}; card vs CPU w_recon rel L2 {r:.2e} <= {CVAE_REL_L2}, code agreement '
          f'{agree:.4f}')

    print(f'launches: serving {json.dumps(launches)}; stage-1 ChamferEMD steps {json.dumps(train_launches)}; '
          f'stage 2 {json.dumps(stage2_launches)}; stage-1 Chamfer and ChamferSinkhorn steps and entry point '
          f'{json.dumps(objective_launches)}', flush=True)
    print('kernel | headline shape | ms | plain ms | library ms | bound ms (by) | share of bound | launches '
          'serving / stage 1 / stage 2 / stage-1 Chamfer and ChamferSinkhorn', flush=True)
    for name in KERNEL_INFO:
        k = kernels[name]
        lib = 'none' if k['library_ms'] is None else f'{k["library_ms"]:.4f}'
        print(f'{name} | {k["shape"]} | {k["ms"]:.4f} | {k["plain_ms"]:.4f} | {lib} | {k["bound_ms"]:.4f} '
              f'({k["bound_by"]}) | {k["bound_ms"] / k["ms"]:.2%} | {launches[name]} / {train_launches[name]} / '
              f'{stage2_launches[name]} / {objective_launches[name]}', flush=True)
    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': KERNEL_INFO[name][0], 'replaces': KERNEL_INFO[name][1],
         'launches': launches[name] + train_launches[name] + stage2_launches[name] + objective_launches[name],
         **kernels[name]}
        for name in KERNEL_INFO
    ]}
    if failures:
        print(f'chip_smoke: {len(failures)} check(s) failed: {failures}', file=sys.stderr)
        return 1
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

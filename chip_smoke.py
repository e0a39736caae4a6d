"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels of ``pccf_torch`` from
``pccf_torch/csrc`` and holds each against its plain PyTorch version on the
card at every shape the main path gives it (and times both).  Then it drives
the two halves of the main path with the flagship model (random weights from
``--seed``, the composed configuration unmodified, graph filtering on):

- serving: counterfactual requests through
  ``pccf_torch.serve.CounterfactualServer``, checked for shapes,
  finiteness, batch invariance and agreement with the same model on the CPU;
- training: stage-1 VQ-VAE steps through ``pccf_torch.train.Trainer``
  (batch 8, 2048 points, ChamferEMD + embedding loss, AdamW at lr 0.004) on
  a fixed batch of synthetic clouds, checked for finite and falling losses,
  and one step at batch 2 and 512 points against the same step on the CPU.

Each path must have launched every kernel it runs (launch counts set to 0
just before the path and read just after).

    python3 chip_smoke.py [--seed 0]

It also prints the compiler's register and spill report for every kernel, a
``torch.profiler`` table of one batch-16 request and of one training step,
the warm request latency at batch 1 and 16, and the training step time,
samples/s and peak memory, the numbers PERF.md quotes.

Prints the card's name and power limit, one JSON line with the kernels, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing
no result, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPS = 10  # timed calls per kernel and version; the median is reported

# tolerances, each with its reason
KNN_SET_AGREEMENT = 0.999  # fp32 distances in another order: near-ties at the k-th slot may swap
PCGEN_REL_L2 = 1e-2  # the kernel rounds weights to bf16 (as the TPU kernel does), activations TF32
CVAE_REL_L2 = 1e-3  # 3xTF32 products: about fp32 rounding, through 8 transformer layers
CODE_AGREEMENT = 0.99  # VQ argmin on card vs CPU
RECON_REL_L2 = 1e-2  # the decode runs the bf16-weight PCGen kernel on the card
BATCH_INVARIANCE = 1e-4  # rel. max difference of a request alone vs inside a batch
SCATTER_REL_MAX = 1e-5  # fp32 atomics add in an order that changes from run to run; |diff| / max |plain|
SUM_POOL_REL_MAX = 1e-5  # the kernel adds the k rows in slot order, the plain reduction in its own
EMD_COST_RTOL = 1e-4  # exp and the row and column sums recomputed in another order than the plain version
EMD_GRAD_REL_L2 = 1e-3  # the same, through nine levels of remaining mass
# one training step on the card against the same step on the CPU: atomics
# reorder the scatter sums, EMD recomputes its exps, cuBLAS and the CPU add
# GEMM terms in other orders, and a kNN neighbour or VQ code at a near-tie may
# differ between the two
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_REL_L2 = 1e-2  # per parameter
STEP_UPDATE_REL_L2 = 1e-2  # the AdamW update of all trained parameters together

KERNEL_INFO = {
    'knn': ('pccf_torch/csrc/knn.cu', 'pccf/kernels/pallas_knn.py:183'),
    'graph_max_pool': ('pccf_torch/csrc/graph_max_pool.cu', 'pccf/kernels/pallas_gather.py:218'),
    'pcgen_mix': ('pccf_torch/csrc/pcgen_mix.cu', 'pccf/kernels/pallas_pcgen.py:133'),
    'cvae_cf': ('pccf_torch/csrc/cvae_cf.cu', 'pccf/kernels/pallas_cvae.py:203'),
    'gather_neighbors': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:309'),
    'scatter_add_rows': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:182'),
    'graph_max_pool_src': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:121'),
    'scatter_add_slots': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:200'),
    'graph_sum_pool': ('pccf_torch/csrc/gather_scatter.cu', 'pccf/kernels/pallas_gather.py:256'),
    'chamfer_match_cost': ('pccf_torch/csrc/emd.cu', 'pccf/kernels/pallas_emd.py:218'),
}
SERVING_KERNELS = ('knn', 'graph_max_pool', 'pcgen_mix', 'cvae_cf', 'gather_neighbors')
TRAINING_KERNELS = ('knn', 'gather_neighbors', 'scatter_add_rows', 'graph_max_pool_src', 'scatter_add_slots',
                    'graph_sum_pool', 'chamfer_match_cost')
TRAIN_BATCH, WARM_STEPS, TIMED_STEPS = 8, 2, 10
STEPS_PER_EPOCH = 100  # the timed steps stay in epoch 0: lr 0.004 throughout


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm((got - want).double()) / (torch.linalg.norm(want.double()) + 1e-30))


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from pccf_torch.config import SliceConfig
    from pccf_torch.data import synthetic
    from pccf_torch.data.structures import Inputs, Targets
    from pccf_torch.kernels import _build, api, cvae, emd, gather, knn, ops, pcgen
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import gumbel_uniform, init_from_seed
    from pccf_torch.serve import CounterfactualServer
    from pccf_torch.train import Trainer, get_autoencoder_loss

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

    # ---- each kernel against its plain version at the flagship shapes ----
    with torch.inference_mode():
        # every (C, k) the main path gives kNN: the encoder's k=25 and the
        # classifier's k=20 at C = 3, 64, 128 (C=64 twice per model), and
        # graph filtering's k=4 on the decoded cloud
        knn_errs, knn_ms = [], {}
        for c in (3, 64, 128):
            for k in (25, 20, 4) if c == 3 else (25, 20):
                x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(dev)
                got, want = knn.knn_cuda(x, k), knn.plain(x, k)
                torch.cuda.synchronize()
                agree, err = knn_check(x, k, got, want)
                knn_errs.append(err)
                self_first = bool((got[..., 0] == torch.arange(n, device=dev)).float().mean() > 0.999)
                knn_ms[c, k] = (time_ms(lambda: knn.knn_cuda(x, k), REPS), time_ms(lambda: knn.plain(x, k), REPS))
                check(agree >= KNN_SET_AGREEMENT and self_first,
                      f'knn C={c} k={k}: neighbour-set agreement {agree:.6f}, self first, max |kth-distance diff| '
                      f'{err:.2e}; {knn_ms[c, k][0]:.3f} ms (plain {knn_ms[c, k][1]:.3f} ms)')
        kernels['knn'] = {'max_abs_err': max(knn_errs), 'ms': knn_ms[128, 25][0], 'plain_ms': knn_ms[128, 25][1],
                          'shape': '(16, 2048, 128) k=25'}

        # every (F, k) the main path gives max-pool: F = 64, 128, 256 at the
        # encoder's k=25 and the classifier's k=20
        pool_errs, pool_ms = [], {}
        for f in (64, 128, 256):
            for k in (25, 20):
                x = torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32)).to(dev)
                idx = knn.knn_cuda(torch.from_numpy(rng.standard_normal((b, n, 8)).astype(np.float32)).to(dev), k)
                err = float((gather.graph_max_pool_cuda(x, idx) - gather.plain(x, idx)).abs().max())
                pool_errs.append(err)
                pool_ms[f, k] = (time_ms(lambda: gather.graph_max_pool_cuda(x, idx), REPS),
                                 time_ms(lambda: gather.plain(x, idx), REPS))
                check(err == 0.0, f'graph_max_pool F={f} k={k}: bit-exact (max |diff| {err}); '
                      f'{pool_ms[f, k][0]:.3f} ms (plain {pool_ms[f, k][1]:.3f} ms)')
        kernels['graph_max_pool'] = {'max_abs_err': max(pool_errs), 'ms': pool_ms[256, 25][0],
                                     'plain_ms': pool_ms[256, 25][1], 'shape': '(16, 2048, 256) k=25'}

        dec = vqvae.decoder
        pack = dec.pack()
        m = torch.relu(torch.from_numpy(rng.standard_normal((b, n, 64)).astype(np.float32))).to(dev)
        w = torch.from_numpy(rng.standard_normal((b, cfg.autoencoder.w_dim)).astype(np.float32)).to(dev)
        run_k = lambda: pcgen.pcgen_mix_cuda(m, w, pack, tau=dec.tau, act_slope=0.0)  # noqa: E731
        run_p = lambda: pcgen.plain(m, w, pack, tau=dec.tau, act_slope=0.0)  # noqa: E731
        got, want = run_k(), run_p()
        r = rel_l2(got, want)
        check(r <= PCGEN_REL_L2 and bool(torch.isfinite(got).all()), f'pcgen_mix: rel L2 {r:.3e} <= {PCGEN_REL_L2}')
        kernels['pcgen_mix'] = {'max_abs_err': float((got - want).abs().max()), 'rel_l2': r,
                                'ms': time_ms(run_k, REPS), 'plain_ms': time_ms(run_p, REPS),
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
                              'shape': '(16, 256, 4), d=512, 8 heads, 2+2+4 layers'}

        # ---- the training path's kernels at its shapes, batch 8 ----------
        bt = TRAIN_BATCH

        def graph(k: int, c: int = 8) -> torch.Tensor:
            return knn.knn_cuda(torch.from_numpy(rng.standard_normal((bt, n, c)).astype(np.float32)).to(dev), k)

        def randn(*shape: int) -> torch.Tensor:
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

        def timed(name: str, shape: str, run_k, run_p, err: float, ok: bool, what: str) -> None:
            ms, plain_ms = time_ms(run_k, REPS), time_ms(run_p, REPS)
            check(ok, f'{name} {shape}: {what}; {ms:.3f} ms (plain {plain_ms:.3f} ms)')
            entry = kernels.setdefault(name, {'max_abs_err': 0.0, 'shapes': {}})
            entry['max_abs_err'] = max(entry['max_abs_err'], err)
            entry['shapes'][shape] = [round(ms, 4), round(plain_ms, 4)]
            entry.update(ms=ms, plain_ms=plain_ms, shape=shape)  # the last (largest) shape is the headline

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
                  f'max and slots bit-exact {exact}, bit-equal to graph_max_pool {eval_equal}')
            g = randn(bt, n, f)
            got, want = gather.scatter_add_slots_cuda(g, idx25, slots, n), ops.scatter_add_slots(g, idx25, slots, n)
            r = rel_max(got, want)
            timed('scatter_add_slots', f'({bt}, {n}, {f}) k=25', lambda: gather.scatter_add_slots_cuda(g, idx25, slots, n),
                  lambda: ops.scatter_add_slots(g, idx25, slots, n), float((got - want).abs().max()),
                  r <= SCATTER_REL_MAX, f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}')
        # sum-pool of [u, u^2] and its row scatter at every encoder width, k=25
        for f2 in (128, 256, 512):
            x = randn(bt, n, f2)
            got, want = gather.graph_sum_pool_cuda(x, idx25), ops.graph_sum_pool(x, idx25)
            r = rel_max(got, want)
            timed('graph_sum_pool', f'({bt}, {n}, {f2}) k=25', lambda: gather.graph_sum_pool_cuda(x, idx25),
                  lambda: ops.graph_sum_pool(x, idx25), float((got - want).abs().max()), r <= SUM_POOL_REL_MAX,
                  f'rel max diff {r:.2e} <= {SUM_POOL_REL_MAX}')
            got, want = gather.scatter_add_rows_cuda(x, idx25, n), ops.scatter_add_rows(x, idx25, n)
            r = rel_max(got, want)
            timed('scatter_add_rows', f'({bt}, {n}, {f2}) k=25', lambda: gather.scatter_add_rows_cuda(x, idx25, n),
                  lambda: ops.scatter_add_rows(x, idx25, n), float((got - want).abs().max()), r <= SCATTER_REL_MAX,
                  f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}')
        # graph filtering's gather on the decoded cloud, k=4: serving (batch
        # 16) and training (batch 8, with its scatter: N*4 rows of one neighbour)
        for bb in (b, bt):
            cloud = torch.from_numpy(rng.standard_normal((bb, n, 3)).astype(np.float32)).to(dev)
            idx4 = knn.knn_cuda(cloud, 4)
            exact = torch.equal(gather.gather_neighbors_cuda(cloud, idx4), ops.gather_neighbors(cloud, idx4))
            timed('gather_neighbors', f'({bb}, {n}, 3) k=4', lambda: gather.gather_neighbors_cuda(cloud, idx4),
                  lambda: ops.gather_neighbors(cloud, idx4), 0.0 if exact else float('inf'), exact,
                  f'bit-exact {exact}')
        g = randn(bt, n * 4, 3)
        flat = idx4.reshape(bt, n * 4, 1)
        got, want = gather.scatter_add_rows_cuda(g, flat, n), ops.scatter_add_rows(g, flat, n)
        r = rel_max(got, want)
        timed('scatter_add_rows', f'({bt}, {n}*4, 3) k=1', lambda: gather.scatter_add_rows_cuda(g, flat, n),
              lambda: ops.scatter_add_rows(g, flat, n), float((got - want).abs().max()), r <= SCATTER_REL_MAX,
              f'rel max diff {r:.2e} <= {SCATTER_REL_MAX}')
        kernels['scatter_add_rows'].update(zip(('ms', 'plain_ms', 'shape'), (
            *kernels['scatter_add_rows']['shapes'][f'({bt}, {n}, 512) k=25'], f'({bt}, {n}, 512) k=25')))
        # the ChamferEMD loss on a decoded cloud against its reference
        x1 = torch.from_numpy(synthetic.batch(args.seed, bt, n)).to(dev)
        x2 = (x1 + 0.05 * randn(bt, n, 3)).contiguous()
        got, want = emd.chamfer_match_cost_cuda(x1, x2), emd.plain(x1, x2)
        cost_err = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        g1, g2 = rel_l2(got[1], want[1]), rel_l2(got[2], want[2])
        nn_exact = all(torch.equal(a, w) for a, w in zip(got[3:], want[3:]))
        timed('chamfer_match_cost', f'({bt}, {n}, 3) x ({bt}, {n}, 3)', lambda: emd.chamfer_match_cost_cuda(x1, x2),
              lambda: emd.plain(x1, x2), float((got[0] - want[0]).abs().max()),
              cost_err <= EMD_COST_RTOL and max(g1, g2) <= EMD_GRAD_REL_L2 and nn_exact,
              f'cost rel err {cost_err:.2e} <= {EMD_COST_RTOL}, grad rel L2 {g1:.2e} / {g2:.2e} <= '
              f'{EMD_GRAD_REL_L2}, Chamfer min/argmin exact {nn_exact}')

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
    tcfg = cfg.autoencoder.train
    model = build_vqvae(cfg)
    init_from_seed(model, args.seed + 2)
    base_state = copy.deepcopy(model.state_dict())
    model = model.to(dev)
    trainer = Trainer(model, get_autoencoder_loss(tcfg), tcfg, STEPS_PER_EPOCH, seed=args.seed)
    batch = torch.from_numpy(synthetic.batch(args.seed + 3, TRAIN_BATCH, n)).to(dev)
    inputs, targets = Inputs(batch), Targets(batch)
    losses, step_ms, step_launches = [], [], []
    train_launches = dict.fromkeys(KERNEL_INFO, 0)
    for step in range(WARM_STEPS + TIMED_STEPS):
        if step == WARM_STEPS:
            torch.cuda.reset_peak_memory_stats()
        api.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.run_step(inputs, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = api.launch_counts()
        step_launches.append(counts)
        for name, count in counts.items():
            train_launches[name] += count
        losses.append({k: float(v) for k, v in metrics.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(list(m.values())).all() for m in losses),
          f'training: every loss finite over {len(losses)} steps')
    first, last = losses[0]['Loss'], losses[-1]['Loss']
    check(last < first, f'training: loss {first:.4f} at step 1 -> {last:.4f} at step {len(losses)} on the same batch')
    print('training losses per step: ' + json.dumps([{k: round(v, 5) for k, v in m.items()} for m in losses]),
          flush=True)
    for name in TRAINING_KERNELS:
        per_step = [c[name] for c in step_launches]
        check(min(per_step) > 0, f'{name}: launches per training step {per_step}')
    timed_ms = step_ms[WARM_STEPS:]
    q1, med, q3 = np.percentile(timed_ms, [25, 50, 75])
    print(f'training step (batch {TRAIN_BATCH}, {n} points): median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f} ms '
          f'over {TIMED_STEPS} (host clock, synchronised); {TRAIN_BATCH / med * 1e3:.1f} samples/s; '
          f'peak memory {peak_gib:.3f} GiB (max_memory_allocated)', flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_step(inputs, targets)
        torch.cuda.synchronize()
    print('profile of one training step:', flush=True)
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=25, max_name_column_width=60), flush=True)

    # ---- one training step on the card against the CPU, batch 2 x 512 ----
    pts = 512
    gen = torch.Generator().manual_seed(args.seed + 4)
    small = torch.from_numpy(synthetic.batch(args.seed + 5, 2, pts))
    sampling = torch.randn((2, pts, cfg.autoencoder.decoder.sample_dim), generator=gen)
    noise = gumbel_uniform((2, pts, cfg.autoencoder.decoder.n_components), gen, torch.device('cpu'))

    def one_step(device: torch.device):
        m = build_vqvae(cfg)
        m.load_state_dict(base_state)
        m = m.to(device)
        tr = Trainer(m, get_autoencoder_loss(tcfg), tcfg, STEPS_PER_EPOCH)
        before = {k: p.detach().clone() for k, p in m.named_parameters()}
        cl = small.to(device)
        out = tr.run_step(Inputs(cl, initial_sampling=sampling.to(device)), Targets(cl), noise.to(device))
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters() if p.grad is not None}
        updates = {k: (p.detach() - before[k]).cpu() for k, p in m.named_parameters()}
        return {k: float(v) for k, v in out.items()}, grads, updates

    t0 = time.perf_counter()
    gpu_step, cpu_step = one_step(dev), one_step(torch.device('cpu'))
    print(f'card and CPU step at batch 2 x {pts}: {time.perf_counter() - t0:.1f} s', flush=True)
    for name, value in cpu_step[0].items():
        r = abs(gpu_step[0][name] - value) / abs(value)
        check(r <= STEP_LOSS_RTOL, f'card vs CPU step: {name} {gpu_step[0][name]:.6f} vs {value:.6f}, rel {r:.2e}')
    check(set(gpu_step[1]) == set(cpu_step[1]) and not any(k.startswith('w_autoencoder.') for k in gpu_step[1]),
          f'card vs CPU step: the same {len(cpu_step[1])} parameters have gradients, none of the frozen inner CVAE')
    grad_errs = {k: rel_l2(gpu_step[1][k], v) for k, v in cpu_step[1].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= STEP_GRAD_REL_L2,
          f'card vs CPU step: largest per-parameter gradient rel L2 {grad_errs[worst]:.2e} ({worst}), '
          f'median {float(np.median(list(grad_errs.values()))):.2e}')
    upd = rel_l2(torch.cat([gpu_step[2][k].flatten() for k in cpu_step[1]]),
                 torch.cat([cpu_step[2][k].flatten() for k in cpu_step[1]]))
    frozen_still = all(not bool(v.any()) for k, v in gpu_step[2].items() if k.startswith('w_autoencoder.'))
    check(upd <= STEP_UPDATE_REL_L2 and frozen_still,
          f'card vs CPU step: AdamW update rel L2 {upd:.2e} <= {STEP_UPDATE_REL_L2}; frozen inner CVAE unmoved '
          f'{frozen_still}')

    print(f'launches: serving {json.dumps(launches)}; training ({len(losses)} steps) {json.dumps(train_launches)}',
          flush=True)
    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': KERNEL_INFO[name][0], 'replaces': KERNEL_INFO[name][1],
         'launches': launches[name] + train_launches[name], **kernels[name]}
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

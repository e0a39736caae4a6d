"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels of ``pccf_torch`` from
``pccf_torch/csrc``, holds each against its plain PyTorch version on the card
at the flagship shapes (and times both), then serves counterfactual requests
through ``pccf_torch.serve.CounterfactualServer`` with the flagship model
(random weights from ``--seed``, graph filtering off) and checks the answers:
shapes, finiteness, batch invariance, that every kernel was launched, and
agreement with the same model run on the CPU.

    python3 chip_smoke.py [--seed 0]

It also prints the compiler's register and spill report for every kernel, the
device time of one batch-16 request by kernel (``torch.profiler``) and the
warm request latency at batch 1 and 16, the numbers PERF.md quotes.

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

KERNEL_INFO = {
    'knn': ('pccf_torch/csrc/knn.cu', 'pccf/kernels/pallas_knn.py:183'),
    'graph_max_pool': ('pccf_torch/csrc/graph_max_pool.cu', 'pccf/kernels/pallas_gather.py:218'),
    'pcgen_mix': ('pccf_torch/csrc/pcgen_mix.cu', 'pccf/kernels/pallas_pcgen.py:133'),
    'cvae_cf': ('pccf_torch/csrc/cvae_cf.cu', 'pccf/kernels/pallas_cvae.py:203'),
}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from pccf_torch.config import SliceConfig
    from pccf_torch.data.structures import Inputs
    from pccf_torch.kernels import _build, api, cvae, gather, knn, pcgen
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.serve import CounterfactualServer

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
        # classifier's k=20 at C = 3, 64, 128 (C=64 twice per model)
        knn_errs, knn_ms = [], {}
        for c in (3, 64, 128):
            for k in (25, 20):
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

    # ---- the main path: a server answering requests ----------------------
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
    for name, count in launches.items():
        check(count > 0, f'{name}: {count} launches on the main path')
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

    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': KERNEL_INFO[name][0], 'replaces': KERNEL_INFO[name][1],
         'launches': launches[name], **kernels[name]}
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

"""Repeat the serving path, the training steps and the auction EMD on one
card for a while, every call's output held bit-equal to the first call's.
A kernel that faults or races only now and then shows here as a CUDA error
or a changed bit, where one run of ``chip_smoke.py`` may miss it.

    cd <checkout> && python3 tools/kernel_stress.py [--seconds 240] [--seed 0] [--cases serve,train,auction,variants]
        [--traced]

The cases, taken in turns until ``--seconds`` have passed (``--cases``
picks groups of them):

- ``serve``: the f32 server's counterfactual requests of 1, 16 and 64
  clouds of the flagship (its classifier, VQ-VAE encoder, CVAE chain, W
  stacks, PCGen mix and graph filter), four requests of 16 in flight, the
  bf16-cast server's request of 16, generation of 16, and
  ``pcgen_mix_partial`` / ``pcgen_general_partial`` at the expert-parallel
  shares of ``chip_smoke.partial_kernels`` (the flagship's and path E's
  decoders at 16 x 2048, two shares of four components);
- ``train``: the checked step of each of ``chip_smoke.dp_cases`` (stage 1
  under ChamferEMD at 8 x 2048 with one and two BatchNorm statistic groups,
  stage 2 at 32, the classifier at 16 x 2048) from its weights, its
  metrics the output;
- ``auction``: ``api.auction_emd`` at ``chip_smoke.AUCTION_CASES``;
- ``variants``: requests of 1 and 16 to a server of each of paths A-E
  (``chip_smoke.variant_configs``), and of 16 and 64 to the server of two
  replicas on the card.

The models and data are ``chip_smoke.py``'s, made from ``--seed``.  With
``--traced`` every call runs inside a ``torch.profiler`` session tracing
the card, as ``chip_smoke.traced`` times a call.

Prints the card's name and power limit, a line a case (calls, kernel
launches, calls that differed from the first), and one JSON line of those
numbers last.  Exits 1 at the first error, its traceback printed last, or
when any call differed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def serve_cases(cfg, seed: int, dev: torch.device) -> dict:
    """Each serving case's name and a function of no argument giving its
    output on the host."""
    from pccf_torch.kernels import pcgen
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import act_slope, init_from_seed
    from pccf_torch.serve import CounterfactualServer

    vqvae, classifier = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vqvae, seed)
    init_from_seed(classifier, seed + 1)
    vqvae, classifier = vqvae.to(dev).eval(), classifier.to(dev).eval()
    server = CounterfactualServer(vqvae, classifier, seed=seed)
    cast = CounterfactualServer(vqvae, classifier, seed=seed, cast_bf16=True)
    rng = np.random.default_rng([seed, 22])
    n = cfg.data.n_input_points

    def request(b: int, seed0: int) -> tuple:
        clouds = (rng.standard_normal((b, n, 3)) / 2).astype(np.float32)
        return clouds, np.arange(b) % 2, None, 1.0, seed0 + np.arange(b)

    out = {f'server {b}': (lambda a=request(b, 100 * b): server.counterfactual(*a)) for b in (1, 16, 64)}
    in_flight = [request(16, 1000 + 16 * i) for i in range(4)]
    out['server 4 x 16 in flight'] = lambda: np.stack(
        [f.result() for f in [server.counterfactual_async(*a) for a in in_flight]])
    for b in (1, 16, 64):
        out[f'bf16 cast server {b}'] = lambda a=request(b, 5000 + 100 * b): cast.counterfactual(*a)
    out['generate 16'] = lambda: server.generate(16, seed=seed)

    decoders = cs.tep_models(cfg, seed)['decoders']
    for name, kernel in (('flagship', 'pcgen_mix_partial'), ('path E', 'pcgen_general_partial')):
        dec, w, samp = decoders[name]
        dec = dec.to(dev).eval()
        w, samp = w.to(dev), samp.to(dev)
        with torch.inference_mode():
            m = samp
            for block in dec.map:
                m = block(m)
            m = m.contiguous()
            pack = dec.pack()
        count = dec.n_components // cs.TEP_RANKS
        fn = getattr(pcgen, f'{kernel}_cuda')
        for r in range(cs.TEP_RANKS):
            share = pack.share(r * count, count, r == 0)

            def run(fn=fn, m=m, w=w, share=share, slope=act_slope(dec.act)):
                with torch.inference_mode():
                    return torch.cat([t.flatten() for t in fn(m, w, share, act_slope=slope)]).cpu().numpy()

            out[f'{kernel} ({name}) share {r}'] = run
    return out


def variant_cases(cfg, seed: int, dev: torch.device) -> dict:
    """Each variant request's name and a function giving its output."""
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.serve import DEFAULT_BUCKETS, CounterfactualServer

    classifier = build_classifier(cfg)
    init_from_seed(classifier, seed + 1)
    classifier = classifier.to(dev).eval()
    rng = np.random.default_rng([seed, 24])
    n = cfg.data.n_input_points
    clouds = (rng.standard_normal((64, n, 3)) / 2).astype(np.float32)
    out = {}
    for key, v_cfg in cs.variant_configs(cfg).items():
        model = build_vqvae(v_cfg)
        init_from_seed(model, seed + 40 + ord(key))
        server = CounterfactualServer(model.to(dev).eval(), classifier, seed=seed)
        for b in (1, 16):
            out[f'path {key} server {b}'] = lambda server=server, b=b: server.counterfactual(clouds[:b],
                                                                                            np.arange(b) % 2)
    vqvae = build_vqvae(cfg)
    init_from_seed(vqvae, seed)
    buckets = [b for b in DEFAULT_BUCKETS if b % 2 == 0]
    dp = CounterfactualServer(vqvae.to(dev).eval(), classifier, buckets, seed=seed, devices=[dev, dev])
    for b in (16, 64):
        out[f'two replicas server {b}'] = lambda b=b: dp.counterfactual(clouds[:b], np.arange(b) % 2)
    return out


def train_cases(cfg, seed: int, dev: torch.device) -> dict:
    """Each training step's name and a function giving its metrics."""
    out = {}
    for case in cs.dp_cases(cfg, seed):
        def run(case=case):
            return np.array(list(cs.dp_steps(cfg, case, seed, dev)['metrics'].values()))

        out[f'{case["kind"]} step, {case["groups"]} statistic groups'] = run
    return out


def auction_cases(seed: int, dev: torch.device) -> dict:
    """Each auction case's name and a function giving its distances and
    assignment."""
    from pccf_torch.kernels import api

    rng = np.random.default_rng([seed, 23])
    out = {}
    for b, n, m, contract in cs.AUCTION_CASES:
        x1, x2 = (torch.from_numpy(rng.random((b, p, 3)).astype(np.float32)).to(dev) for p in (n, m))

        def run(x1=x1, x2=x2, contract=contract):
            dis, assignment = api.auction_emd(x1, x2, *cs.AUCTION_CONTRACTS[contract])
            return np.concatenate([dis.cpu().numpy().ravel(), assignment.cpu().numpy().ravel()])

        out[f'auction_emd ({b}, {n}) x ({b}, {m}) {contract}'] = run
    return out


def stress(seconds: float, seed: int, groups: list[str], traced: bool) -> dict:
    from pccf_torch.config import SliceConfig
    from pccf_torch.kernels import api

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SliceConfig()
    runs = {}
    if 'serve' in groups:
        runs.update(serve_cases(cfg, seed, dev))
    if 'train' in groups:
        runs.update(train_cases(cfg, seed, dev))
    if 'auction' in groups:
        runs.update(auction_cases(seed, dev))
    if 'variants' in groups:
        runs.update(variant_cases(cfg, seed, dev))
    first = {name: run() for name, run in runs.items()}
    torch.cuda.synchronize()
    calls = dict.fromkeys(runs, 0)
    differed = dict.fromkeys(runs, 0)
    launches = {name: collections.Counter() for name in runs}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for name, run in runs.items():
            api.reset_launch_counts()
            session = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                         torch.profiler.ProfilerActivity.CUDA]) \
                if traced else contextlib.nullcontext()
            with session:
                got = run()
                torch.cuda.synchronize()
            launches[name].update(api.launch_counts())
            calls[name] += 1
            differed[name] += int(not np.array_equal(got, first[name]))
    return {name: {'calls': calls[name], 'differed': differed[name],
                   'launches': {k: v for k, v in launches[name].items() if v}} for name in runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seconds', type=float, default=240.0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--cases', default='serve,train,auction,variants')
    ap.add_argument('--traced', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('kernel_stress: no CUDA device', file=sys.stderr)
        return 2
    faulthandler.enable()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    result = stress(args.seconds, args.seed, args.cases.split(','), args.traced)
    for name, r in result.items():
        print(f'{name}: {r["calls"]} calls, {r["differed"]} differed from the first, launches '
              f'{json.dumps(r["launches"])}', flush=True)
    print(json.dumps({'seconds': time.perf_counter() - t0, 'cases': result}), flush=True)
    return 1 if any(r['differed'] for r in result.values()) else 0


if __name__ == '__main__':
    try:
        code = main()
    except BaseException:  # a CUDA error: its traceback last, then out before the tensors are freed
        sys.stdout.flush()
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(code)

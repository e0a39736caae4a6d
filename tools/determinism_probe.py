"""Run-to-run differences on the card: a flagship stage-1 step and graph
filtering's backward.

    python3 tools/determinism_probe.py [--reps 50]

1. One stage-1 step (the flagship model from a seed, a synthetic batch of
   8 x 2048) run twice from the same state, five pairs in each mode: the
   gradient leaves that differ in default mode under each objective, under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (with the
   warnings that names), and in default mode under ChamferEMD with the
   Chamfer backward's earlier ``scatter_add_`` put back.
2. Graph filtering's backward at (8, 2048, 3), scale 0.5 (the card test
   ``test_graph_filter_backward_matches_plain[8-2048-0.5]``), ``--reps``
   times: rel-L2 of the kernel against the plain version on the card and on
   the CPU, and of the plain version on the card against its first run,
   for the ordered plain row scatter and for the earlier ``index_add_``.

Prints one line a finding.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pccf_torch.config import SliceConfig  # noqa: E402
from pccf_torch.data import synthetic  # noqa: E402
from pccf_torch.data.structures import Inputs, Targets  # noqa: E402
from pccf_torch.kernels import chamfer, graph_filter  # noqa: E402
from pccf_torch.models import build_vqvae  # noqa: E402
from pccf_torch.nn.layers import init_for_training  # noqa: E402
from pccf_torch.train import Trainer, get_autoencoder_loss  # noqa: E402


def scatter_add_like(like: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like).scatter_add_(1, idx.long()[..., None].expand(-1, -1, like.shape[-1]), g)


def index_add_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    b, m, c = g.shape
    k = idx.shape[-1]
    rows = (idx.long() + n * torch.arange(b, device=g.device)[:, None, None]).reshape(-1)
    src = g[:, :, None, :].expand(b, m, k, c).reshape(-1, c)
    return torch.zeros((b * n, c), dtype=g.dtype, device=g.device).index_add_(0, rows, src).reshape(b, n, c)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=50)
    ap.add_argument('--pairs', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('determinism_probe: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'device: {torch.cuda.get_device_name(0)}', flush=True)

    cfg = SliceConfig()
    model = build_vqvae(cfg)
    init_for_training(model, 0)
    state = model.state_dict()
    batch = torch.from_numpy(synthetic.batch(3, 8, cfg.data.n_input_points)).to(dev)

    def grads(recon_loss: str) -> dict[str, torch.Tensor]:
        m = build_vqvae(cfg)
        m.load_state_dict(state)
        m = m.to(dev)
        loss = get_autoencoder_loss(dataclasses.replace(cfg, autoencoder=dataclasses.replace(
            cfg.autoencoder, train=dataclasses.replace(cfg.autoencoder.train, recon_loss=recon_loss))))
        tr = Trainer(m, loss, cfg.autoencoder.train, 100, seed=0)
        tr.run_step(Inputs(batch), Targets(batch))
        return {k: p.grad.detach().clone() for k, p in m.named_parameters() if p.grad is not None}

    def differing(label: str, recon_loss: str = 'ChamferEMD') -> None:
        counts, names = [], set()
        for _ in range(args.pairs):
            a, b = grads(recon_loss), grads(recon_loss)
            diff = [k for k in a if not torch.equal(a[k], b[k])]
            counts.append(len(diff))
            names.update(diff)
        print(f'stage-1 step, {label}: differing gradient leaves per pair {counts} of {len(a)}; '
              f'{sorted(names)}', flush=True)

    for recon_loss in ('ChamferEMD', 'Chamfer', 'ChamferSinkhorn'):
        differing(f'default mode, {recon_loss}', recon_loss)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            differing('deterministic algorithms (warn only)')
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split('\n')[0] for w in caught if 'deterministic' in str(w.message)})
    print(f'warnings under deterministic algorithms: {named}', flush=True)
    kept = chamfer._scatter_rows
    chamfer._scatter_rows = scatter_add_like
    try:
        differing('the Chamfer backward\'s earlier scatter_add_')
    finally:
        chamfer._scatter_rows = kept

    def randn(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)

    spreads: dict[str, list[float]] = {k: [] for k in (
        'kernel vs plain on the card', 'kernel vs plain on the CPU', 'plain on the card vs its first run',
        'kernel vs index_add_ plain on the card', 'index_add_ plain on the card vs its first run')}
    first = first_old = None
    kernel_same = True
    for _ in range(args.reps):
        x = randn((8, 2048, 3), 58) * 0.5
        g = randn((8, 2048, 3), 59)
        _, idx, mean = graph_filter.graph_filter_cuda(x)
        dx = graph_filter.graph_filter_backward_cuda(x, idx, mean, g)
        plain = graph_filter.plain_backward(x, idx, mean, g)
        rows, row_idx = graph_filter._rows(x, idx, mean, g)
        old = index_add_rows(rows, row_idx, x.shape[1])
        cpu = graph_filter.plain_backward(x.cpu(), idx.cpu(), mean.cpu(), g.cpu())
        first = plain if first is None else first
        first_old = old if first_old is None else first_old
        kernel_same &= torch.equal(dx, graph_filter.graph_filter_backward_cuda(x, idx, mean, g))
        spreads['kernel vs plain on the card'].append(rel_l2(dx, plain))
        spreads['kernel vs plain on the CPU'].append(rel_l2(dx.cpu(), cpu))
        spreads['plain on the card vs its first run'].append(rel_l2(plain, first))
        spreads['kernel vs index_add_ plain on the card'].append(rel_l2(dx, old))
        spreads['index_add_ plain on the card vs its first run'].append(rel_l2(old, first_old))
    for k, v in spreads.items():
        print(f'graph filter backward, {k} over {args.reps} runs: rel L2 min {min(v):.3e} median '
              f'{float(np.median(v)):.3e} max {max(v):.3e} ({len(set(v))} distinct)', flush=True)
    print(f'graph filter backward kernel bits repeat: {kernel_same}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

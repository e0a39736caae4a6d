"""The counterfactual decode split by latent channel, on a quality run's
checkpoints (``tools/cf_anatomy.py``).

The inner CVAE has three routes from a cloud's class into the decoder: z1
(priced by KLD1), the posterior's difference ``d_mu2`` (priced by KLD2) and
the conditioning probabilities through the conditional prior ``p_mu2``
(free).  :func:`cf_variant` is ``VQVAE.generate_counterfactual`` with
switches on them:

- ``full``:         z2 = p_mu2(target) + d_mu2(target, x)  (the counterfactual rule)
- ``delta_src``:    z2 = p_mu2(target) + d_mu2(source, x)  (the difference blind to the target)
- ``prior_only``:   z2 = p_mu2(target)                      (the difference removed)
- ``prior_z1zero``: z2 = p_mu2(target), z1 = 0              (the prior channel alone)

For each mode and each target class it reports the classifier's accuracy
on the counterfactuals labelled with the target (the counterfeit success),
the histogram of where they land, and the pairwise L2 of the conditional
prior's means over the classes (a collapsed prior cannot steer).  The
models are the tag's latest classifier and VQ-VAE checkpoints
(:func:`pccf_torch.train.w_autoencoder.load_models`), the clouds the
surrogate's test split, in the quality run's batches of 16, on the card
unless ``--cpu``.  The nets run one by one (each stack through its kernel
where its gate holds), where ``full`` at serving runs the fused chain.

    python -m pccf_torch.tools.cf_anatomy [--tag quality_torch] [--cpu] [--smoke]
        [--n-train N] [--n-test N] [--target-value F] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from pccf_torch.data.structures import Inputs
from pccf_torch.tools import REPO, SMOKE_MODEL, SMOKE_W_MODEL, SURROGATE, device_of

MODES = ('full', 'delta_src', 'prior_only', 'prior_z1zero')
BATCH = 16
SAMPLING_SEED = 5  # the decoder's initial sampling of every batch


def cf_variant(vqvae, inputs: Inputs, sample_logits: torch.Tensor, target_dim: int, target_value: float,
               mode: int):
    """``VQVAE.generate_counterfactual`` with channel switches; ``mode``
    indexes :data:`MODES`.  The nets run one by one."""
    wae = vqvae.w_autoencoder
    x = vqvae.encode(inputs).w_q.reshape(-1, wae.n_codes, wae.embedding_dim)
    old_probs = wae.get_probabilities_from_logits(sample_logits)
    target = F.one_hot(torch.as_tensor(target_dim, device=x.device).long(), wae.n_classes).to(old_probs.dtype)
    probs = (1.0 - target_value) * old_probs + target_value * target.expand_as(old_probs)
    data = wae.encode_z1(x).replace(probs=probs)
    p_mu2, p_log_var2 = wae.z2_prior(probs).chunk(2, dim=2)  # the prior always on the interpolated target
    d_mu2, _ = wae.z2_posterior(old_probs if mode == 1 else probs, x).chunk(2, dim=2)
    z2 = p_mu2 if mode >= 2 else p_mu2 + d_mu2
    z1 = torch.zeros_like(data.mu1) if mode == 3 else data.mu1
    data = wae.decode(data.replace(z1=z1, z2=z2, p_mu2=p_mu2, p_log_var2=p_log_var2, d_mu2=d_mu2), vqvae.codebook)
    return vqvae._decode_from_idx(data, inputs)


def with_sampling(vqvae, inputs: Inputs, generator: torch.Generator) -> Inputs:
    """``inputs`` with the decoder's initial sampling drawn from ``generator``."""
    shape = (inputs.cloud.shape[0], vqvae.n_inference_output_points, vqvae.decoder.sample_dim)
    return Inputs(inputs.cloud, inputs.indices, torch.randn(shape, generator=generator, device=generator.device))


@torch.no_grad()
def prior_distances(vqvae) -> list[list[float]]:
    """Pairwise L2 between the conditional prior's means ``p_mu2`` of the
    one-hot classes."""
    wae = vqvae.w_autoencoder
    eye = torch.eye(wae.n_classes, device=vqvae.codebook.device)
    mu = wae.z2_prior(eye).chunk(2, dim=2)[0]
    return torch.sqrt(((mu[:, None] - mu[None]) ** 2).sum(dim=(2, 3))).cpu().tolist()


@torch.no_grad()
def anatomy(classifier, vqvae, batches: list, n_classes: int, target_value: float = 1.0) -> dict:
    """Every mode's counterfeit success over ``batches`` of ``(Inputs,
    Targets)`` and every target: overall, a target, the predictions'
    histogram a target, the seconds."""
    device = vqvae.codebook.device
    modes = {}
    for mode, name in enumerate(MODES):
        t0 = time.time()
        gen = torch.Generator(device=device).manual_seed(SAMPLING_SEED)
        hits = np.zeros((n_classes, 2), np.int64)
        hist = np.zeros((n_classes, n_classes), np.int64)
        for inputs, _ in batches:
            logits = classifier(inputs)
            for j in range(n_classes):
                out = cf_variant(vqvae, with_sampling(vqvae, inputs, gen), logits, j, target_value, mode)
                pred = classifier(Inputs(out.recon)).argmax(1).cpu().numpy()
                hits[j] += ((pred == j).sum(), pred.shape[0])
                np.add.at(hist[j], pred, 1)
        modes[name] = {'overall': round(float(hits[:, 0].sum() / hits[:, 1].sum()), 4),
                       **{f'to_{j}': round(float(h / t), 4) for j, (h, t) in enumerate(hits)},
                       'pred_hist': hist.tolist(), 'wall_s': round(time.time() - t0, 1)}
        print(name, json.dumps(modes[name]), flush=True)
    return modes


def overrides(n_train: int | None, n_test: int | None, smoke: bool) -> list[str]:
    """The quality run's surrogate at ``n_train`` / ``n_test`` clouds (by
    default its 512 / 128, or 16 / 8 with ``smoke``) and, with ``smoke``, its
    tiny widths."""
    out = [*SURROGATE, f'data.dataset.settings.n_train={n_train or (16 if smoke else 512)}',
           f'data.dataset.settings.n_test={n_test or (8 if smoke else 128)}',
           'data.dataset.settings.variability=0.85', 'user.checkpoint_every=0', 'user.trackers.tensorboard=false',
           'user.trackers.csv=false', 'user.seed=0']
    return out + [*SMOKE_MODEL, *SMOKE_W_MODEL] if smoke else out


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tag', default='quality_torch')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU instead of the card')
    ap.add_argument('--smoke', action='store_true', help='the tiny widths of quality_run --smoke')
    ap.add_argument('--n-train', type=int, default=None, help='the quality run\'s (512; 16 with --smoke)')
    ap.add_argument('--n-test', type=int, default=None, help='the quality run\'s (128; 8 with --smoke)')
    ap.add_argument('--target-value', type=float, default=1.0)
    ap.add_argument('--out', default=None,
                    help='the record\'s file (default: cf_anatomy_<tag>.json in the experiment directory)')
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse(argv)
    device = device_of(args.cpu)
    os.environ.setdefault('ROOT_EXP_DIR', str(REPO / 'experiments' / args.tag))
    os.environ.setdefault('DATASET_DIR', str(REPO / 'datasets'))

    from pccf_torch import cli
    from pccf_torch.data.dataset import get_datasets
    from pccf_torch.data.protocols import Singleton
    from pccf_torch.experiment import Experiment
    from pccf_torch.train.runners import Loader
    from pccf_torch.train.w_autoencoder import load_models

    Singleton.reset_all()
    cfg, tree = cli.get_config(overrides(args.n_train, args.n_test, args.smoke))
    record: dict = {'tag': args.tag, 'target_value': args.target_value, 'device': str(device), 'modes': {}}
    with Experiment(cfg, tree, name=args.tag).create_run(record=False):
        classifier, vqvae = load_models(cfg, device)
        _, test_set = get_datasets(cfg, device)
        batches = list(Loader(test_set, BATCH).batches())
        record['prior_mu2_pairwise_l2'] = [[round(v, 3) for v in row] for row in prior_distances(vqvae)]
        print('prior pairwise L2:', record['prior_mu2_pairwise_l2'], flush=True)
        record['modes'] = anatomy(classifier, vqvae, batches, cfg.data.n_classes, args.target_value)
    out = pathlib.Path(args.out) if args.out else pathlib.Path(os.environ['ROOT_EXP_DIR']) / f'cf_anatomy_{args.tag}.json'
    out.write_text(json.dumps(record, indent=1))
    print(f'wrote {out}')
    return record


if __name__ == '__main__':
    main()

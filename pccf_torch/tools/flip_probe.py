"""Micro-scale counterfactual *flip* probe of the conditional W-autoencoder
(``tools/flip_probe.py``).

Trains the inner CVAE alone, at tiny widths (16 codes of 4, z1 and z2 of
4, a projection of 32, two heads, the exact GELU), on synthetic code
embeddings whose class shifts their distribution (:func:`make_data`),
under the exact stage-2 objective: MSE plus ``anneal * (beta_z1 * KLD1 +
beta_z2 * KLD2)``, the anneal a cosine ramp over ``anneal_frac`` of the
run, AdamW.  Then it asks whether ``generate_counterfactual`` towards
class j decodes nearer class j's prototype than any other class's, for
every sample and every other class.  A flip rate well above chance (1 / 4)
shows that the conditioning channel (probabilities -> conditional prior ->
z2 -> decoder) learns and steers.

A loop of torch steps replaces JAX's ``lax.scan``: the batch order comes
from the same numpy permutations, the posterior's noise from a
``torch.Generator`` seeded ``seed + 13``.  The model and the steps run on
the card unless ``device`` (``--cpu``) says otherwise.

    python -m pccf_torch.tools.flip_probe [--epochs N] [--beta-z1 F] [--beta-z2 F]
        [--lr F] [--seed N] [--anneal-frac F] [--n-per-class N] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pccf_torch.data.structures import WInputs
from pccf_torch.models.w_autoencoders import WAutoEncoder
from pccf_torch.nn.layers import gelu_exact, init_for_training
from pccf_torch.nn.w_networks import (
    ConditionalPrior,
    TransformerWConditionalEncoder,
    TransformerWDecoder,
    TransformerWEncoder,
)
from pccf_torch.train.losses import diff_gaussian_kld, gaussian_kld

T, E, Z1, Z2, D = 16, 4, 4, 4, 32  # codes, embedding, z1, z2, projection
N_CLASSES = 4
BOOK = 8  # codebook entries a code
BATCH = 64
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def make_data(n_per_class: int, seed: int = 0, proto_scale: float = 1.2,
              inst_scale: float = 0.4) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Class prototypes plus instance variation in the code space, and peaked
    logits: ``(w (N, T, E), logits (N, C), labels (N,), prototypes (C, T,
    E))`` from ``numpy.random.default_rng(seed)``, drawn in the JAX tool's
    order."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((N_CLASSES, T, E)).astype(np.float32) * proto_scale
    labels = np.repeat(np.arange(N_CLASSES), n_per_class)
    inst = rng.standard_normal((labels.size, T, E)).astype(np.float32) * inst_scale
    w = protos[labels] + inst
    logits = (np.eye(N_CLASSES, dtype=np.float32)[labels] * 10.0
              + rng.standard_normal((labels.size, N_CLASSES)).astype(np.float32) * 0.1)
    return w, logits, labels, protos


def make_wae() -> WAutoEncoder:
    """The micro CVAE: transformer nets of one layer (FF 64, dropout 0)."""
    return WAutoEncoder(
        encoder=TransformerWEncoder(E, Z1, T, D, 2, (64,), gelu_exact, (0.0,)),
        decoder=TransformerWDecoder(E, Z1, Z2, T, D, 2, (64,), gelu_exact, (0.0,)),
        z2_prior=ConditionalPrior(N_CLASSES, T, Z2),
        z2_posterior=TransformerWConditionalEncoder(E, N_CLASSES, Z2, T, D, 2, (64,), gelu_exact, (0.0,)),
        n_codes=T, embedding_dim=E, z1_dim=Z1, z2_dim=Z2, n_classes=N_CLASSES, conditional=True,
    )


def make_codebook() -> np.ndarray:
    return np.random.default_rng(1).standard_normal((T, BOOK, E)).astype(np.float32)


def schedule(n: int, epochs: int, seed: int, anneal_frac: float) -> tuple[np.ndarray, np.ndarray]:
    """The sample indices of every step ``(steps, batch)`` (one permutation
    an epoch from ``default_rng(seed + 7)``, cut to whole batches) and each
    step's anneal ``0.5 (1 - cos(min(epoch / (anneal_frac epochs), 1) pi))``."""
    batch = min(BATCH, n)
    per_epoch = n // batch
    perm_rng = np.random.default_rng(seed + 7)
    idx = np.concatenate([perm_rng.permutation(n)[: per_epoch * batch] for _ in range(epochs)])
    epoch_of_step = np.repeat(np.arange(epochs), per_epoch)
    anneal = 0.5 * (1.0 - np.cos(np.minimum(epoch_of_step / (anneal_frac * epochs), 1.0) * np.pi))
    return idx.reshape(epochs * per_epoch, batch), anneal.astype(np.float32)


def loss_terms(wae: WAutoEncoder, codebook: torch.Tensor, w_b: torch.Tensor, lg_b: torch.Tensor, anneal: float,
               beta_z1: float, beta_z2: float, eps=None, generator: torch.Generator | None = None):
    """The stage-2 objective of one batch in train mode: ``(loss, MSE, KLD1,
    KLD2)``, each a batch mean, the posterior's noise ``eps`` (z1, z2) or
    drawn from ``generator``."""
    out = wae(WInputs(w_b, lg_b), codebook, eps, generator)
    mse = torch.sum((out.w_recon - w_b.reshape(out.w_recon.shape)) ** 2, dim=1).mean()
    kld1 = torch.sum(gaussian_kld(out.mu1, out.log_var1), dim=(1, 2)).mean()
    kld2 = torch.sum(diff_gaussian_kld(out.d_mu2, out.d_log_var2, out.p_log_var2), dim=(1, 2)).mean()
    return mse + anneal * (beta_z1 * kld1 + beta_z2 * kld2), mse, kld1, kld2


@torch.no_grad()
def flips(wae: WAutoEncoder, codebook: torch.Tensor, w: torch.Tensor, logits: torch.Tensor, labels: np.ndarray,
          protos: np.ndarray) -> tuple[float, dict[str, float]]:
    """The counterfactual of every sample towards every class, classified by
    the nearest prototype; the share of samples not of class j whose
    counterfactual lands at j, overall and a target."""
    n = w.shape[0]
    protos_flat = protos.reshape(N_CLASSES, -1)
    hits = total = 0
    per_target = {}
    for j in range(N_CLASSES):
        rec = wae.generate_counterfactual(WInputs(w, logits), codebook, j, 1.0).w_recon
        rec = rec.reshape(n, -1).cpu().numpy()
        pred = ((rec[:, None, :] - protos_flat[None]) ** 2).sum(-1).argmin(1)
        mask = labels != j
        hits_j = int((pred[mask] == j).sum())
        per_target[f'to_{j}'] = hits_j / int(mask.sum())
        hits += hits_j
        total += int(mask.sum())
    return hits / total, per_target


def run(epochs: int = 400, beta_z1: float = 0.1, beta_z2: float = 4.0, lr: float = 3e-3, seed: int = 0,
        quiet: bool = False, n_per_class: int = 64, anneal_frac: float = 1.0, proto_scale: float = 1.2,
        inst_scale: float = 0.4, device: torch.device | str = 'cuda') -> dict:
    """Train the micro CVAE and count its flips; the JAX tool's signature
    and result keys, and ``device`` (the card unless the caller asks for the
    CPU).  ``anneal_frac``: the share of the run over which the KLD weight
    ramps to 1."""
    if epochs < 1:
        raise ValueError('epochs must be >= 1 (the anneal schedule needs a run)')
    device = torch.device(device)
    w, logits, labels, protos = make_data(n_per_class, seed=seed, proto_scale=proto_scale, inst_scale=inst_scale)
    wae = make_wae()
    init_for_training(wae, seed)
    wae = wae.to(device).train()
    codebook = torch.from_numpy(make_codebook()).to(device)
    w_flat = torch.from_numpy(w.reshape(w.shape[0], -1)).to(device)
    logits_t = torch.from_numpy(logits).to(device)
    steps, anneal = schedule(w_flat.shape[0], epochs, seed, anneal_frac)
    steps_t = torch.from_numpy(steps).to(device)
    opt = torch.optim.AdamW(wae.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    trace = []
    for s in range(steps.shape[0]):
        opt.zero_grad(set_to_none=True)
        rows = steps_t[s]
        terms = loss_terms(wae, codebook, w_flat[rows], logits_t[rows], float(anneal[s]), beta_z1, beta_z2,
                           generator=gen)
        terms[0].backward()
        opt.step()
        trace.append(torch.stack([t.detach() for t in terms]))
    trace = torch.stack(trace).cpu().numpy()  # (steps, 4): loss, MSE, KLD1, KLD2
    per_epoch = steps.shape[0] // epochs
    if not quiet:
        for ep in range(0, epochs, max(1, epochs // 8)):
            s = (ep + 1) * per_epoch - 1
            print(f'ep {ep:4d} loss {trace[s, 0]:8.3f} mse {trace[s, 1]:8.3f} kld1 {trace[s, 2]:7.3f} '
                  f'kld2 {trace[s, 3]:7.3f} anneal {anneal[s]:.3f}')

    wae.eval()
    flip_rate, per_target = flips(wae, codebook, w_flat, logits_t, labels, protos)
    # the reconstruction MSE over all the data, in eval (the posterior sampled)
    with torch.no_grad():
        eval_gen = torch.Generator(device=device).manual_seed(seed + 11)
        out = wae(WInputs(w_flat, logits_t), codebook, None, eval_gen)
        final_mse = float(torch.sum((out.w_recon - w_flat.reshape(out.w_recon.shape)) ** 2, dim=1).mean())
    result = {
        'flip_rate': flip_rate,
        'chance': 1.0 / N_CLASSES,
        'per_target': per_target,
        'final_mse': final_mse,
        'final_kld1': float(trace[-1, 2]),
        'final_kld2': float(trace[-1, 3]),
        'epochs': epochs, 'beta_z1': beta_z1, 'beta_z2': beta_z2,
    }
    if not quiet:
        print(json.dumps(result, indent=1))
    return result


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs', type=int, default=400)
    ap.add_argument('--beta-z1', type=float, default=0.1)
    ap.add_argument('--beta-z2', type=float, default=4.0)
    ap.add_argument('--lr', type=float, default=3e-3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--anneal-frac', type=float, default=1.0)
    ap.add_argument('--n-per-class', type=int, default=64)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU instead of the card')
    args = ap.parse_args(argv)
    from pccf_torch.tools import device_of

    return run(args.epochs, args.beta_z1, args.beta_z2, args.lr, args.seed, n_per_class=args.n_per_class,
               anneal_frac=args.anneal_frac, device=device_of(args.cpu))


if __name__ == '__main__':
    main()

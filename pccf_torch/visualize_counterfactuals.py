"""Render counterfactual edits of selected samples (``visualize_counterfactuals.py``).

For each index of ``user.plot.sample_indices`` in the test split (the
validation split unless ``final``), the entry point loads the classifier
and the VQ-VAE of the current experiment's checkpoints and runs, on the
card unless ``user.cpu``:

- the reconstruction (the VQ-VAE's eval forward);
- the double reconstruction through the inner CVAE, conditioned on the
  classifier's logits (``double_reconstruct_with_logits``);
- one counterfactual towards each class, at ``user.counterfactual_value``
  (``generate_counterfactual``: kNN, the pools, the CVAE chain, PCGen and
  graph filtering on the card);

prints the classifier's probabilities of each cloud, as the JAX script does
(``visualize_counterfactuals.py:18-77``), and renders each cloud, then all
the counterfactuals together, into ``<version_dir>/images/<name>/
sample_<i>`` (:func:`pccf_torch.utils.visualization.render_cloud`).  The
decoder's sampling and the posterior's noise of a sample are drawn on the
host from one generator seeded with ``user.seed`` (JAX draws every call
from the key 0), so the card and the CPU see the same numbers.

    python -m pccf_torch.visualize_counterfactuals data/dataset=synthetic user.cpu=true
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig
from pccf_torch.data.dataset import get_dataset
from pccf_torch.data.protocols import Partitions
from pccf_torch.data.structures import Inputs
from pccf_torch.generate import images_dir
from pccf_torch.utils.visualization import render_cloud


def _probs(classifier, cloud: torch.Tensor, prefix: str) -> tuple[torch.Tensor, np.ndarray, str]:
    """The logits and probabilities of ``cloud (1, N, 3)`` and the printed line."""
    logits = classifier(Inputs(cloud=cloud))
    probs = torch.softmax(logits.float(), dim=1)[0].cpu().numpy()
    text = f'{prefix}: ({" ".join(f"{p:.2f}" for p in probs)})'
    print(text)
    return logits, probs, text


def draws(vqvae, generator: torch.Generator) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One sample's decoder sampling ``(1, n_out, sample_dim)`` and the
    posterior's standard normal noise of z1 and z2, in that order, from
    ``generator`` (on the host)."""
    wae = vqvae.w_autoencoder
    sampling = torch.randn((1, vqvae.n_inference_output_points, vqvae.decoder.sample_dim), generator=generator)
    eps = (torch.randn((1, wae.n_codes, wae.z1_dim), generator=generator),
           torch.randn((1, wae.n_codes, wae.z2_dim), generator=generator))
    return sampling, eps


Cloud = tuple[str, np.ndarray, np.ndarray, str, np.ndarray | None]


@torch.no_grad()
def sample_clouds(classifier, vqvae, inputs: Inputs, value: float, n_classes: int,
                  sampling: torch.Tensor, eps: tuple[torch.Tensor, torch.Tensor]) -> list[Cloud]:
    """``(name, cloud (N, 3), probabilities, printed line, VQ codes)`` of the
    input (no codes), its reconstruction, its double reconstruction and one
    counterfactual a class (``visualize_counterfactuals.py:48-71``), every
    cloud of batch 1 on the models' device."""
    dev = vqvae.codebook.device
    cloud = inputs.cloud.to(dev)
    sample = Inputs(cloud=cloud, indices=None if inputs.indices is None else inputs.indices.to(dev),
                    initial_sampling=sampling.to(dev))
    eps = tuple(e.to(dev) for e in eps)
    out = []

    def keep(name: str, c: torch.Tensor, prefix: str, idx: torch.Tensor | None = None) -> torch.Tensor:
        logits, probs, text = _probs(classifier, c, prefix)
        out.append((name, c[0].float().cpu().numpy(), probs, text, None if idx is None else idx[0].cpu().numpy()))
        return logits

    logits = keep('original', cloud, 'Original')
    data = vqvae(sample)
    keep('reconstruction', data.recon, 'Reconstruction', data.idx)
    data = vqvae.double_reconstruct_with_logits(sample, logits, eps)
    keep('double_reconstruction', data.recon, 'Double Reconstruction', data.idx)
    for j in range(n_classes):
        data = vqvae.generate_counterfactual(sample, logits, torch.tensor([j], device=dev),
                                             torch.tensor([[value]], device=dev))
        keep(f'counterfactual_{j}', data.recon, f'Counterfactual to {j}', data.idx)
    return out


def create_and_render_counterfactuals(cfg: SliceConfig, device: torch.device, classifier=None,
                                      vqvae=None) -> dict[int, list[Cloud]]:
    """Every sample index's clouds (:func:`sample_clouds`), printed and
    rendered; the models from the current experiment's checkpoints unless
    given.  Raises ``ValueError`` for an index past the split."""
    if classifier is None or vqvae is None:
        from pccf_torch.train.w_autoencoder import load_models

        classifier, vqvae = load_models(cfg, device)
    classifier, vqvae = classifier.eval(), vqvae.eval()
    interactive = cfg.user.plot.interactive
    base_dir = images_dir(cfg)
    dataset = get_dataset(cfg, Partitions.test if cfg.final else Partitions.val, device)
    dataset.set_inference(True)
    n_classes = cfg.data.n_classes
    results = {}
    for i in cfg.user.plot.sample_indices:
        if i >= len(dataset):
            raise ValueError(f'Index {i} too large for dataset of length {len(dataset)}')
        save_dir = base_dir / f'sample_{i}'
        save_dir.mkdir(parents=True, exist_ok=True)
        for old in save_dir.iterdir():
            old.unlink()
        inputs, targets = dataset.__getitems__([i])
        print(f'Sample {i} with label {int(targets.label[0])}:')
        sampling, eps = draws(vqvae, torch.Generator().manual_seed(cfg.user.seed or 0))
        clouds = sample_clouds(classifier, vqvae, inputs, cfg.user.counterfactual_value, n_classes, sampling, eps)
        print()
        for _, cloud, _, text, _ in clouds:
            render_cloud((cloud,), title=text, interactive=interactive, save_dir=save_dir)
        render_cloud([c for name, c, *_ in clouds if name.startswith('counterfactual')], title='Counterfactuals',
                     interactive=interactive, save_dir=save_dir)
        results[i] = clouds
    return results


def main(argv: list[str] | None = None) -> dict:
    return cli.run(argv, create_and_render_counterfactuals)


if __name__ == '__main__':
    main()

"""Random samples from the generative prior (``generate.py``).

The entry point loads the VQ-VAE of the current experiment's checkpoints,
samples z1 and z2 from the priors (the Dirichlet class condition on the
conditional model), decodes them through the codebook and PCGen, renders
each cloud into ``<version_dir>/images/<name>/generated/<i>.png``
(:func:`pccf_torch.utils.visualization.render_cloud`: the HTML viewer too
with ``user.plot.interactive``, the viewer alone where matplotlib is
missing) and returns the clouds.

    python -m pccf_torch.generate data/dataset=synthetic user.cpu=true
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig, paths
from pccf_torch.models.autoencoders import VQVAE
from pccf_torch.utils.visualization import render_cloud


def generate_random_samples(cfg: SliceConfig, vqvae: VQVAE, seed: int = 0,
                            device: torch.device | str = 'cuda') -> np.ndarray:
    """``cfg.user.generate.batch_size`` clouds ``(B, n_inference_output_points,
    3)`` from the priors (``generate.py:17-46``), with ``bias_value`` added to
    column ``bias_dim`` of every z1 row.  The model moves to ``device``, the
    card unless the caller asks for the CPU; the draws come from a host
    generator seeded by ``seed``, so both devices see the same numbers."""
    gen_cfg, n_codes, z1_dim = cfg.user.generate, cfg.autoencoder.n_codes, cfg.w_autoencoder.z1_dim
    z1_bias = torch.zeros((gen_cfg.batch_size, n_codes, z1_dim))
    if gen_cfg.bias_value:
        if not 0 <= gen_cfg.bias_dim < z1_dim:
            raise ValueError(f'user.generate.bias_dim={gen_cfg.bias_dim} is out of range for z1_dim={z1_dim}')
        z1_bias[:, :, gen_cfg.bias_dim] = gen_cfg.bias_value
    vqvae = vqvae.to(device).eval()
    with torch.inference_mode():
        out = vqvae.generate(gen_cfg.batch_size, None, z1_bias, generator=torch.Generator().manual_seed(seed))
    return out.recon.float().cpu().numpy()


def stage(cfg: SliceConfig, device: torch.device) -> np.ndarray:
    """``generate.py``'s run inside the current experiment."""
    from pccf_torch.train.w_autoencoder import load_models

    _, vqvae = load_models(cfg, device)
    clouds = generate_random_samples(cfg, vqvae, cfg.user.seed or 0, device)
    print(f'generated {clouds.shape[0]} clouds of {clouds.shape[1]} points')
    save_dir = images_dir(cfg) / 'generated'
    for i, cloud in enumerate(clouds):
        render_cloud((cloud,), title=str(i), interactive=cfg.user.plot.interactive, save_dir=save_dir)
    return clouds


def images_dir(cfg: SliceConfig) -> pathlib.Path:
    """Where the entry points render: ``<version_dir>/images/<name>``
    (``generate.py:22``, ``visualize_counterfactuals.py:31``)."""
    return paths().version_dir / 'images' / cfg.name


def main(argv: list[str] | None = None) -> np.ndarray:
    return cli.run(argv, stage)


if __name__ == '__main__':
    main()

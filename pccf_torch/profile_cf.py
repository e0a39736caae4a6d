"""Stage attribution of the counterfactual decode (``profile_cf.py``).

Times each stage of ``VQVAE.generate_counterfactual`` on the marginal timer
(:func:`pccf_torch.utils.timing.marginal_time`): the whole counterfactual,
the encoder, the inner CVAE's counterfactual and the decode from the code
indices (the argmin, PCGen, graph filtering), each chained on its own
output.  The flagship model of the experiment tree (random weights from
seed 0, folded once as a server folds them), a batch of ``batch`` clouds of
``n`` points, on the card unless ``--cpu``.

    python -m pccf_torch.profile_cf [--batch 16] [--n 2048] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pccf_torch import cli
from pccf_torch.data.structures import Inputs, Outputs, WInputs
from pccf_torch.kernels import ops
from pccf_torch.models import build_vqvae
from pccf_torch.nn.layers import init_from_seed
from pccf_torch.utils.timing import marginal_time


def flagship(n: int, device: torch.device, overrides: tuple[str, ...] = ()):
    """The experiment tree's model at ``n`` points in and out on a 2-class
    synthetic set, random weights from seed 0, folded, in eval on ``device``."""
    cfg, _ = cli.get_config(['data/dataset=synthetic', 'data.dataset.n_classes=2', f'data.n_input_points={n}',
                             f'data.n_target_points={n}', *overrides])
    model = build_vqvae(cfg)
    init_from_seed(model, 0)
    model = model.to(device).eval()
    model.prepack()
    return cfg, model


def inputs(cfg, model, batch: int, n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clouds ``(B, n, 3)``, class logits and the decoder's initial sampling
    from seeds 0 and 3."""
    rng = np.random.default_rng(0)
    cloud = torch.from_numpy(rng.standard_normal((batch, n, 3)).astype(np.float32) / 2).to(device)
    logits = torch.from_numpy(rng.standard_normal((batch, cfg.data.n_classes)).astype(np.float32)).to(device)
    gen = torch.Generator().manual_seed(3)
    sampling = torch.randn((batch, model.n_inference_output_points, model.decoder.sample_dim), generator=gen)
    return cloud, logits, sampling.to(device)


@torch.inference_mode()
def main(batch: int = 16, n: int = 2048, k_short: int = 1, k_long: int = 9, repeats: int = 2,
         device: torch.device | str = 'cuda', overrides: tuple[str, ...] = ()) -> dict[str, float]:
    """Print and return each stage's seconds a batch."""
    device = torch.device(device)
    cfg, model = flagship(n, device, overrides)
    cloud, logits, sampling = inputs(cfg, model, batch, n, device)
    w_q0 = model.encode(Inputs(cloud)).w_q

    def stage_full(carry):
        c, lg = carry
        r = model.generate_counterfactual(Inputs(c, None, sampling), lg, 1, 1.0).recon
        return c + 1e-3 * r, lg

    def stage_encoder(carry):
        c, lg = carry
        return c + 1e-6 * torch.mean(model.encode(Inputs(c)).w_q) * c, lg

    def stage_wae(carry):
        wq, lg = carry
        data = model.w_autoencoder.generate_counterfactual(WInputs(wq, lg), model.codebook, 1, 1.0)
        return wq + 1e-6 * torch.mean(data.w_recon) * wq, lg

    def stage_decode(carry):
        # the decode from the quantised indices alone: the argmin, PCGen, filtering
        wq, c = carry
        _, idx, _ = ops.vq_assign(wq, model.codebook)
        r = model._decode_from_idx(Outputs(w_q=wq, idx=idx), Inputs(c, None, sampling)).recon
        return wq + 1e-6 * torch.mean(r) * wq, c

    out = {}
    for name, fn, carry in (('full', stage_full, (cloud, logits)), ('encoder', stage_encoder, (cloud, logits)),
                            ('wae_inner', stage_wae, (w_q0, logits)), ('decode_pcgen', stage_decode, (w_q0, cloud))):
        dt = out[name] = marginal_time(fn, carry, k_short=k_short, k_long=k_long, repeats=repeats)
        print(f'{name:>14}: {dt * 1e3:7.2f} ms/batch  ({batch / dt:8.1f} samples/s)', flush=True)
    return out


def parse_sizes(description: str, **defaults: int) -> tuple[dict[str, int], torch.device]:
    """``--<size> N`` for each default and ``--cpu``: the sizes and the device."""
    ap = argparse.ArgumentParser(description=description)
    for name, value in defaults.items():
        ap.add_argument(f'--{name.replace("_", "-")}', type=int, default=value)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU instead of the card')
    args = vars(ap.parse_args())
    from pccf_torch.tools import device_of

    return {k: args[k] for k in defaults}, device_of(args['cpu'])


if __name__ == '__main__':
    sizes, dev = parse_sizes(__doc__.split('\n\n')[0], batch=16, n=2048)
    main(**sizes, device=dev)

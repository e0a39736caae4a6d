"""Sub-stage attribution of the inner CVAE's counterfactual (``profile_wae.py``).

On the marginal timer (:func:`pccf_torch.utils.timing.marginal_time`), at
the flagship model's widths (random weights from seed 0, folded once):
the whole counterfactual (``full_cf``: the fused chain where its gate
holds), the W-encoder's z1 alone, z1 and z2 (the conditional prior and the
posterior's difference net), and z1, z2 and the W-decoder with the argmin
(the nets one by one); each chained on its own output, the best of two
measurements, at ``batch`` code sets, on the card unless ``--cpu``.

    python -m pccf_torch.profile_wae [--batch 16] [--cpu]
"""

from __future__ import annotations

import torch

from pccf_torch.data.structures import Inputs, WInputs
from pccf_torch.profile_cf import flagship, inputs, parse_sizes
from pccf_torch.utils.timing import marginal_time


@torch.inference_mode()
def main(batch: int = 16, n: int = 2048, k_short: int = 2, k_long: int = 18, repeats: int = 2,
         device: torch.device | str = 'cuda', overrides: tuple[str, ...] = ()) -> dict[str, float]:
    """Print and return each sub-stage's seconds a batch."""
    device = torch.device(device)
    cfg, model = flagship(n, device, overrides)
    cloud, logits, _ = inputs(cfg, model, batch, n, device)
    w_q0 = model.encode(Inputs(cloud)).w_q
    wae, codebook = model.w_autoencoder, model.codebook

    def codes(wq: torch.Tensor) -> torch.Tensor:
        return wq.reshape(-1, wae.n_codes, wae.embedding_dim)

    def z1_z2(wq, lg):
        x = codes(wq)
        data = wae.encode_z1(x).replace(probs=wae.get_probabilities_from_logits(lg))
        return wae.encode_z2(x, data)

    def stage_full(carry):
        wq, lg = carry
        data = wae.generate_counterfactual(WInputs(wq, lg), codebook, 1, 1.0)
        return wq + 1e-6 * torch.mean(data.w_recon) * wq, lg

    def stage_z1(carry):
        wq, lg = carry
        return wq + 1e-6 * torch.mean(wae.encode_z1(codes(wq)).mu1) * wq, lg

    def stage_z2(carry):
        wq, lg = carry
        data = z1_z2(wq, lg)
        return wq + 1e-6 * torch.mean(data.p_mu2 + data.d_mu2) * wq, lg

    def stage_decode(carry):
        wq, lg = carry
        data = z1_z2(wq, lg)
        data = wae.decode(data.replace(z1=data.mu1, z2=data.p_mu2 + data.d_mu2), codebook)
        return wq + 1e-6 * torch.mean(data.w_recon) * wq, lg

    out = {}
    for name, fn in (('full_cf', stage_full), ('z1_enc', stage_z1), ('z1+z2', stage_z2),
                     ('z1+z2+decode', stage_decode)):
        dt = out[name] = min(marginal_time(fn, (w_q0, logits), k_short, k_long, repeats) for _ in range(2))
        print(f'{name:>14}: {dt * 1e3:6.2f} ms/batch', flush=True)
    return out


if __name__ == '__main__':
    sizes, dev = parse_sizes(__doc__.split('\n\n')[0], batch=16)
    main(**sizes, device=dev)

"""Conditional inner CVAE, counterfactual path (``pccf/models/w_autoencoders.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Outputs, WInputs
from pccf_torch.kernels import api, ops
from pccf_torch.kernels.cvae import CVAEPack, pack_cvae_cf
from pccf_torch.nn.layers import gelu_exact, get_act
from pccf_torch.nn.w_networks import (
    ConditionalPrior,
    TransformerWConditionalEncoder,
    TransformerWDecoder,
    TransformerWEncoder,
)


class WAutoEncoder(nn.Module):
    """Two-level conditional VAE over code embeddings; the codebook is an
    explicit argument, as in the JAX package."""

    def __init__(
        self,
        encoder: nn.Module,
        decoder: nn.Module,
        z2_prior: ConditionalPrior,
        z2_posterior: nn.Module,
        n_codes: int,
        embedding_dim: int,
        z1_dim: int,
        z2_dim: int,
        n_classes: int,
        cf_temperature: float = 5.0,
    ) -> None:
        super().__init__()
        self.encoder, self.decoder, self.z2_prior, self.z2_posterior = encoder, decoder, z2_prior, z2_posterior
        self.n_codes, self.embedding_dim = n_codes, embedding_dim
        self.z1_dim, self.z2_dim, self.n_classes = z1_dim, z2_dim, n_classes
        self.cf_temperature = cf_temperature
        # the chain's folded weights; set once by a server (prepack), else
        # folded on every call
        self.packed: CVAEPack | None = None

    def get_probabilities_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return ops.temperature_softmax(logits, self.cf_temperature, dim=1)

    def generate_counterfactual(
        self,
        inputs: WInputs,
        codebook: torch.Tensor,
        target_dim: int | torch.Tensor,
        target_value: float | torch.Tensor = 1.0,
    ) -> Outputs:
        """Deterministic conditional decode with interpolated probabilities
        (``w_autoencoders.py:92-113``): ``z1 = mu1``, ``z2 = p_mu2 + d_mu2``."""
        x = inputs.w_q.reshape(-1, self.n_codes, self.embedding_dim)
        old_probs = self.get_probabilities_from_logits(inputs.logits)
        target = F.one_hot(torch.as_tensor(target_dim, device=x.device).long(), self.n_classes).to(old_probs.dtype)
        probs = (1.0 - target_value) * old_probs + target_value * target.expand_as(old_probs)
        if self.fused_ok():
            pack = self.packed if self.packed is not None else pack_cvae_cf(self)
            w_recon = api.cvae_cf(x.contiguous(), probs.contiguous(), pack).reshape(x.shape[0], -1)
        elif x.is_cuda:
            # JAX runs the per-stack wformer_encoder_tpu / wformer_decoder_tpu
            # kernels here; the port has no CUDA counterpart for them yet
            raise NotImplementedError(
                'WAutoEncoder: the fused CVAE gate failed (transformer W-nets with exact GELU and one shared '
                'proj_dim), and the unfused chain (wformer_encoder_tpu / wformer_decoder_tpu) is not ported to CUDA'
            )
        else:
            mu1 = self.encoder(x).split(self.z1_dim, dim=2)[0]
            p_mu2 = self.z2_prior(probs).split(self.z2_dim, dim=2)[0]
            d_mu2 = self.z2_posterior(probs, x).split(self.z2_dim, dim=2)[0]
            w_recon = self.decoder(mu1, p_mu2 + d_mu2)
        _, idx, w_dist_2 = ops.vq_assign(w_recon, codebook)
        return Outputs(probs=probs, w_recon=w_recon, idx=idx, w_dist_2=w_dist_2)

    def fused_ok(self) -> bool:
        """The structural gate of the fused chain (``w_autoencoders.py:130-144``):
        transformer nets with the exact GELU and one shared ``proj_dim``."""
        enc, post, dec = self.encoder, self.z2_posterior, self.decoder
        return (
            isinstance(enc, TransformerWEncoder)
            and isinstance(post, TransformerWConditionalEncoder)
            and isinstance(dec, TransformerWDecoder)
            and enc.act is gelu_exact and post.act is gelu_exact and dec.act is gelu_exact
            and enc.proj_dim == post.proj_dim == dec.proj_dim
        )


def build_w_autoencoder(cfg: SliceConfig) -> WAutoEncoder:
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    e, t, c = ae.embedding_dim, ae.n_codes, cfg.data.n_classes
    we, wd, cw = wae.w_encoder, wae.w_decoder, wae.conditional_w_encoder
    return WAutoEncoder(
        encoder=TransformerWEncoder(e, wae.z1_dim, t, we.proj_dim, we.n_heads, we.mlp_dims, get_act(we.act_name)),
        decoder=TransformerWDecoder(
            e, wae.z1_dim, wae.z2_dim, t, wd.proj_dim, wd.n_heads, wd.mlp_dims, get_act(wd.act_name)
        ),
        z2_prior=ConditionalPrior(c, t, wae.z2_dim),
        z2_posterior=TransformerWConditionalEncoder(
            e, c, wae.z2_dim, t, cw.proj_dim, cw.n_heads, cw.mlp_dims, get_act(cw.act_name)
        ),
        n_codes=t,
        embedding_dim=e,
        z1_dim=wae.z1_dim,
        z2_dim=wae.z2_dim,
        n_classes=c,
        cf_temperature=wae.cf_temperature,
    )

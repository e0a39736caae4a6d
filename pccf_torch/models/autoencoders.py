"""Counterfactual VQ-VAE (``pccf/models/autoencoders.py``): the serving path
and the stage-1 reconstruction path that training differentiates."""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Inputs, Outputs, WInputs
from pccf_torch.kernels import ops
from pccf_torch.kernels.cvae import pack_cvae_cf
from pccf_torch.models.w_autoencoders import WAutoEncoder, build_w_autoencoder
from pccf_torch.nn.decoders import PCGenDecoder, build_decoder
from pccf_torch.nn.encoders import DGCNNEncoder
from pccf_torch.nn.layers import get_act


class VQVAE(nn.Module):
    """VQ-VAE over point clouds with the embedded inner CVAE
    (``autoencoders.py:34``, ``conditional=True``)."""

    def __init__(
        self,
        encoder: DGCNNEncoder,
        decoder: PCGenDecoder,
        w_autoencoder: WAutoEncoder,
        n_codes: int,
        book_size: int,
        embedding_dim: int,
        n_training_output_points: int,
        n_inference_output_points: int,
    ) -> None:
        super().__init__()
        self.encoder, self.decoder, self.w_autoencoder = encoder, decoder, w_autoencoder
        self.codebook = nn.Parameter(torch.zeros(n_codes, book_size, embedding_dim))
        self.book_size = book_size
        self.n_training_output_points = n_training_output_points  # the trainer's decoder sampling size
        self.n_inference_output_points = n_inference_output_points  # the server's decoder sampling size

    @torch.no_grad()
    def prepack(self) -> None:
        """Fold the fused paths' weights once (the ``packed`` collection of
        ``pccf/serve.py:315-328``); valid while the weights stay frozen."""
        if self.w_autoencoder.fused_ok():
            self.w_autoencoder.packed = pack_cvae_cf(self.w_autoencoder)
        if self.decoder.fused_ok():
            self.decoder.packed = self.decoder.pack()

    def forward(self, inputs: Inputs, gumbel_uniform: torch.Tensor | None = None) -> Outputs:
        """Encode, quantise with the straight-through gradient, decode
        (``autoencoders.py:60-79``); ``inputs.initial_sampling`` and, in
        training, the decoder's Gumbel noise are passed in."""
        return self.decode(self.encode(inputs), inputs, gumbel_uniform)

    def encode(self, inputs: Inputs) -> Outputs:
        return Outputs(w_q=self.encoder(inputs.cloud, inputs.indices))

    def decode(self, data: Outputs, inputs: Inputs, gumbel_uniform: torch.Tensor | None = None) -> Outputs:
        w_e, idx, _ = ops.vq_assign(data.w_q, self.codebook)
        w = ops.straight_through(w_e, data.w_q)
        recon = self.decoder(w, inputs.initial_sampling, gumbel_uniform)
        return data.replace(w_e=w_e, idx=idx, one_hot_idx=ops.one_hot_idx(idx, self.book_size), w=w, recon=recon)

    def generate_counterfactual(
        self,
        inputs: Inputs,
        sample_logits: torch.Tensor,
        target_dim: int | torch.Tensor,
        target_value: float | torch.Tensor = 1.0,
    ) -> Outputs:
        """Encode, interpolate the class condition towards the target, decode
        (``autoencoders.py:109-122``)."""
        w_q = self.encode(inputs).w_q
        data = self.w_autoencoder.generate_counterfactual(
            WInputs(w_q, sample_logits), self.codebook, target_dim, target_value
        )
        return self._decode_from_idx(data, inputs)

    def _decode_from_idx(self, data: Outputs, inputs: Inputs) -> Outputs:
        w = ops.vq_lookup(data.idx, self.codebook)
        recon = self.decoder(w, inputs.initial_sampling)
        return data.replace(w_e=w, w=w, recon=recon)


def build_vqvae(cfg: SliceConfig) -> VQVAE:
    ae = cfg.autoencoder
    return VQVAE(
        encoder=DGCNNEncoder(ae.w_dim, cfg.data.n_neighbors, get_act(ae.encoder.act_name), ae.encoder.h_dim),
        decoder=build_decoder(ae),
        w_autoencoder=build_w_autoencoder(cfg),
        n_codes=ae.n_codes,
        book_size=ae.book_size,
        embedding_dim=ae.embedding_dim,
        n_training_output_points=cfg.data.n_input_points,
        n_inference_output_points=cfg.data.n_target_points,
    )

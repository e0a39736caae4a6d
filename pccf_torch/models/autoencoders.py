"""VQ-VAE (``pccf/models/autoencoders.py``): the serving path, the stage-1
reconstruction path that training differentiates, the double
reconstruction through the inner CVAE that the evaluation suites run, and
generation from the priors; and ``Oracle``, the baseline that returns part of
its input."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Inputs, Outputs, WInputs
from pccf_torch.dist import mesh
from pccf_torch.kernels import ops
from pccf_torch.kernels.cvae import pack_cvae_cf
from pccf_torch.models.w_autoencoders import GenerationNoise, WAutoEncoder, build_w_autoencoder
from pccf_torch.nn.decoders import PCGenDecoder, build_decoder
from pccf_torch.nn.encoders import get_encoder
from pccf_torch.nn.layers import gumbel_uniform


class Oracle(nn.Module):
    """The first points of the input cloud as its reconstruction
    (``autoencoders.py:21-30``): ``n_training_output_points`` in train mode,
    ``n_inference_output_points`` in eval.  An upper bound for the
    reconstruction metrics; it has no parameters."""

    def __init__(self, n_training_output_points: int, n_inference_output_points: int) -> None:
        super().__init__()
        self.n_training_output_points = n_training_output_points
        self.n_inference_output_points = n_inference_output_points

    def forward(self, inputs: Inputs, *_) -> Outputs:
        n = self.n_training_output_points if self.training else self.n_inference_output_points
        return Outputs(recon=inputs.cloud[:, :n, :])


class VQVAE(nn.Module):
    """VQ-VAE over point clouds with the embedded inner CVAE
    (``autoencoders.py:34``): the ``CounterfactualVQVAE`` when the inner CVAE
    is conditional, else the plain ``VQVAE``."""

    def __init__(
        self,
        encoder: nn.Module,
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
        self.n_training_output_points = n_training_output_points  # decoder sampling size in train mode
        self.n_inference_output_points = n_inference_output_points  # in eval: serving, validation, tests

    @torch.no_grad()
    def prepack(self) -> None:
        """Fold the fused paths' weights once (the ``packed`` collection of
        ``pccf/serve.py:315-328``); valid while the weights stay frozen."""
        if self.w_autoencoder.fused_ok():
            self.w_autoencoder.packed = pack_cvae_cf(self.w_autoencoder)
        if self.decoder.fused_ok():
            self.decoder.packed = self.decoder.pack()

    def forward(
        self, inputs: Inputs, noise: torch.Tensor | None = None, generator: torch.Generator | None = None
    ) -> Outputs:
        """Encode, quantise with the straight-through gradient, decode
        (``autoencoders.py:55-79``).  ``noise`` is the decoder's Gumbel
        uniforms, needed in training.  Where ``inputs.initial_sampling`` or, in
        training, ``noise`` is missing, it is drawn from ``generator``: the
        sampling of ``n_training_output_points`` points in train mode, of
        ``n_inference_output_points`` in eval; in a data-parallel step the
        global batch's draws, of which this rank keeps its rows."""
        if generator is not None:
            n = self.n_training_output_points if self.training else self.n_inference_output_points
            batch, dev = inputs.cloud.shape[0], inputs.cloud.device
            if inputs.initial_sampling is None:
                sampling = mesh.draw(lambda s: torch.randn(s, generator=generator, device=dev),
                                     (batch, n, self.decoder.sample_dim))
                inputs = type(inputs)(inputs.cloud, inputs.indices, sampling)
            if noise is None and self.training:
                noise = gumbel_uniform((batch, n, self.decoder.n_components), generator, dev)
        return self.decode(self.encode(inputs), inputs, noise)

    def encode(self, inputs: Inputs) -> Outputs:
        return Outputs(w_q=self.encoder(inputs.cloud, inputs.indices))

    def encode_quantize(self, inputs: Inputs) -> Outputs:
        """The frozen encode path of the derived datasets
        (``autoencoders.py:81-85``): ``w_q``, its quantisation ``w_e``, the
        selections ``idx`` and their one-hot form."""
        data = self.encode(inputs)
        w_e, idx, _ = ops.vq_assign(data.w_q, self.codebook)
        return data.replace(w_e=w_e, idx=idx, one_hot_idx=ops.one_hot_idx(idx, self.book_size))

    def decode(self, data: Outputs, inputs: Inputs, noise: torch.Tensor | None = None) -> Outputs:
        w_e, idx, _ = ops.vq_assign(data.w_q, self.codebook)
        w = ops.straight_through(w_e, data.w_q)
        recon = self.decoder(w, inputs.initial_sampling, noise)
        return data.replace(w_e=w_e, idx=idx, one_hot_idx=ops.one_hot_idx(idx, self.book_size), w=w, recon=recon)

    @property
    def conditional(self) -> bool:
        return self.w_autoencoder.conditional

    def double_reconstruct(self, inputs: Inputs, eps=None, generator: torch.Generator | None = None) -> Outputs:
        """Encode, the inner CVAE's sampled forward in eval with uniform class
        probabilities, decode its codes (``autoencoders.py:88-99``).  The
        conditional model needs the class logits: it raises ``ValueError``
        (use :meth:`double_reconstruct_with_logits`)."""
        if self.conditional:
            raise ValueError('double_reconstruct on a conditional model: use '
                             'double_reconstruct_with_logits(inputs, logits)')
        return self.double_reconstruct_with_logits(inputs, None, eps, generator)

    def double_reconstruct_with_logits(self, inputs: Inputs, logits: torch.Tensor | None, eps=None,
                                       generator: torch.Generator | None = None) -> Outputs:
        """Encode, the inner CVAE's sampled forward in eval conditioned on
        ``logits``, decode its codes (``autoencoders.py:101-107``).  The
        posterior's standard normal draws ``eps`` (z1, z2) and
        ``inputs.initial_sampling`` are drawn from ``generator`` where not
        given."""
        if inputs.initial_sampling is None:
            if generator is None:
                raise ValueError('double reconstruction: pass the initial sampling or a torch.Generator to draw it')
            shape = (inputs.cloud.shape[0], self.n_inference_output_points, self.decoder.sample_dim)
            inputs = dataclasses.replace(inputs, initial_sampling=torch.randn(shape, generator=generator,
                                                                              device=inputs.cloud.device))
        w_q = self.encode(inputs).w_q
        data = self.w_autoencoder(WInputs(w_q, logits), self.codebook, eps, generator)
        return self._decode_from_idx(data, inputs)

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

    def generate(
        self,
        batch_size: int = 1,
        initial_sampling: torch.Tensor | None = None,
        z1_bias: float | torch.Tensor = 0.0,
        probs: torch.Tensor | None = None,
        noise: GenerationNoise | None = None,
        generator: torch.Generator | None = None,
    ) -> Outputs:
        """Sample the codes from the priors, decode them
        (``autoencoders.py:124-137``).  ``noise`` (the latent draws, see
        :meth:`WAutoEncoder.sample_noise`) and then ``initial_sampling``
        ``(B, n_inference_output_points, sample_dim)`` are drawn from
        ``generator`` where not given, on its device, and moved to the
        model's."""
        data = self.w_autoencoder.generate_discrete_latent_space(
            self.codebook, z1_bias, batch_size, probs, noise, generator)
        dev = self.codebook.device
        if initial_sampling is None:
            if generator is None:
                raise ValueError('generation: pass the initial sampling or a torch.Generator to draw it')
            shape = (batch_size, self.n_inference_output_points, self.decoder.sample_dim)
            initial_sampling = torch.randn(shape, generator=generator, device=generator.device)
        inputs = Inputs(cloud=torch.zeros((batch_size, 1, 3), device=dev), initial_sampling=initial_sampling.to(dev))
        return self._decode_from_idx(data, inputs)

    def _decode_from_idx(self, data: Outputs, inputs: Inputs) -> Outputs:
        w = ops.vq_lookup(data.idx, self.codebook)
        recon = self.decoder(w, inputs.initial_sampling)
        return data.replace(w_e=w, w=w, recon=recon)


def build_vqvae(cfg: SliceConfig) -> VQVAE:
    ae = cfg.autoencoder
    return VQVAE(
        encoder=get_encoder(ae, cfg.data.n_neighbors),
        decoder=build_decoder(ae),
        w_autoencoder=build_w_autoencoder(cfg),
        n_codes=ae.n_codes,
        book_size=ae.book_size,
        embedding_dim=ae.embedding_dim,
        n_training_output_points=cfg.data.n_input_points,
        n_inference_output_points=cfg.data.n_target_points,
    )

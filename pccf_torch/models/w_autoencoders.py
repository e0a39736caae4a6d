"""Conditional inner CVAE (``pccf/models/w_autoencoders.py``): the training
forward of stage 2, the deterministic counterfactual path and sampling from
the priors, with the VampPrior's pseudo-inputs where ``n_pseudo_inputs > 0``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pccf_torch import host
from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Outputs, WInputs
from pccf_torch.dist import mesh
from pccf_torch.kernels import api, ops
from pccf_torch.kernels.cvae import MAX_EMBEDDING, CVAEPack, pack_cvae_cf
from pccf_torch.nn.layers import gelu_exact
from pccf_torch.nn.w_networks import (
    ConditionalPrior,
    TransformerWConditionalEncoder,
    TransformerWDecoder,
    TransformerWEncoder,
    get_conditional_w_encoder,
    get_w_decoder,
    get_w_encoder,
)

Noise = tuple[torch.Tensor, torch.Tensor]  # the standard normal draws of z1 and z2
# generation's draws: z1's and z2's standard normal, the class prior's
# probabilities and, with pseudo-inputs, the pseudo-input each sample's z1 is drawn from
GenerationNoise = tuple[torch.Tensor, ...]


class WAutoEncoder(nn.Module):
    """Two-level conditional VAE over code embeddings; the codebook is an
    explicit argument, as in the JAX package.  Randomness (the posterior's
    Gaussian noise, dropout masks in training) comes from a
    ``torch.Generator`` passed in, or the noise itself is."""

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
        conditional: bool = True,
        n_pseudo_inputs: int = 0,
    ) -> None:
        super().__init__()
        self.encoder, self.decoder, self.z2_prior, self.z2_posterior = encoder, decoder, z2_prior, z2_posterior
        self.n_codes, self.embedding_dim = n_codes, embedding_dim
        self.z1_dim, self.z2_dim, self.n_classes = z1_dim, z2_dim, n_classes
        self.cf_temperature = cf_temperature
        self.conditional = conditional  # False: uniform class probabilities (w_autoencoders.py:233-236)
        self.n_pseudo_inputs = n_pseudo_inputs
        if n_pseudo_inputs > 0:  # the VampPrior (w_autoencoders.py:46-52)
            self.pseudo_inputs = nn.Parameter(torch.zeros(n_pseudo_inputs, n_codes, embedding_dim))
        # the chain's folded weights; set once by a server (prepack), else
        # folded on every call
        self.packed: CVAEPack | None = None

    def forward(
        self, inputs: WInputs, codebook: torch.Tensor, eps: Noise | None = None,
        generator: torch.Generator | None = None,
    ) -> Outputs:
        """Encode, sample the posterior, decode (``w_autoencoders.py:54-60``).
        ``eps`` is the standard normal noise of z1 and z2; drawn from
        ``generator`` when not given (in eval too, as the JAX package samples
        there)."""
        x = inputs.w_q.reshape(-1, self.n_codes, self.embedding_dim)
        data = self.encode_z1(x, generator).replace(probs=self.get_probabilities(inputs))
        data = self.encode_z2(x, data, generator)
        data = self.sample_posterior(data, eps, generator)
        return self.decode(data, codebook, generator)

    def encode_z1(self, x: torch.Tensor | None, generator: torch.Generator | None = None) -> Outputs:
        """z1's statistics; with pseudo-inputs the encoder also takes them, as
        rows after ``x``, and their statistics are split off
        (``w_autoencoders.py:62-72``)."""
        data = Outputs()
        latent = self.encoder(self._get_input(x), generator)
        if self.n_pseudo_inputs > 0:
            latent, pseudo = latent[: -self.n_pseudo_inputs], latent[-self.n_pseudo_inputs:]
            p_mu, p_log_var = pseudo.chunk(2, dim=2)
            data = data.replace(pseudo_mu1=p_mu, pseudo_log_var1=p_log_var)
        mu1, log_var1 = latent.chunk(2, dim=2)
        return data.replace(mu1=mu1, log_var1=log_var1)

    def _get_input(self, x: torch.Tensor | None) -> torch.Tensor:
        """``x``, the pseudo-inputs after it, or the pseudo-inputs alone
        (``w_autoencoders.py:246-254``)."""
        if self.n_pseudo_inputs == 0:
            if x is None:
                raise ValueError('No input available.')
            return x
        if x is None:
            return self.pseudo_inputs
        return torch.cat([x, self.pseudo_inputs], dim=0)

    def encode_z2(self, x: torch.Tensor, data: Outputs, generator: torch.Generator | None = None) -> Outputs:
        p_mu2, p_log_var2 = self.z2_prior(data.probs).chunk(2, dim=2)
        d_mu2, d_log_var2 = self.z2_posterior(data.probs, x, generator).chunk(2, dim=2)
        return data.replace(p_mu2=p_mu2, p_log_var2=p_log_var2, d_mu2=d_mu2, d_log_var2=d_log_var2)

    def sample_posterior(self, data: Outputs, eps: Noise | None = None,
                         generator: torch.Generator | None = None) -> Outputs:
        """``z = ε · exp(½ log σ²) + μ`` for z1 and for z2, whose posterior is
        the prior shifted by the difference net (``w_autoencoders.py:76-79``)."""
        mu2, log_var2 = data.d_mu2 + data.p_mu2, data.d_log_var2 + data.p_log_var2
        if eps is None:
            if generator is None:
                raise ValueError('sample_posterior: pass the noise or a torch.Generator to draw it')
            eps = tuple(mesh.draw(lambda s, d=m.device: torch.randn(s, generator=generator, device=d), m.shape)
                        for m in (data.mu1, mu2))
        eps1, eps2 = eps
        return data.replace(z1=eps1 * torch.exp(0.5 * data.log_var1) + data.mu1,
                            z2=eps2 * torch.exp(0.5 * log_var2) + mu2)

    def decode(self, data: Outputs, codebook: torch.Tensor, generator: torch.Generator | None = None) -> Outputs:
        w_recon = self.decoder(data.z1, data.z2, generator)
        _, idx, w_dist_2 = ops.vq_assign(w_recon, codebook)
        return data.replace(w_recon=w_recon, idx=idx, w_dist_2=w_dist_2)

    def get_probabilities(self, inputs: WInputs) -> torch.Tensor:
        if self.conditional:
            return self.get_probabilities_from_logits(inputs.logits)
        return torch.full((inputs.w_q.shape[0], self.n_classes), 1.0 / self.n_classes, device=inputs.w_q.device)

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
        (``w_autoencoders.py:92-113``): ``z1 = mu1``, ``z2 = p_mu2 + d_mu2``.
        The fused chain runs when its gate holds; otherwise the nets run one
        by one, each stack through its own kernel where its gate holds."""
        x = inputs.w_q.reshape(-1, self.n_codes, self.embedding_dim)
        old_probs = self.get_probabilities_from_logits(inputs.logits)
        target = F.one_hot(torch.as_tensor(target_dim, device=x.device).long(), self.n_classes).to(old_probs.dtype)
        probs = (1.0 - target_value) * old_probs + target_value * target.expand_as(old_probs)
        if self.fused_ok():
            pack = self.packed if self.packed is not None else pack_cvae_cf(self)
            w_recon = api.cvae_cf(x.contiguous(), probs.contiguous(), pack).reshape(x.shape[0], -1)
            _, idx, w_dist_2 = ops.vq_assign(w_recon, codebook)
            return Outputs(probs=probs, w_recon=w_recon, idx=idx, w_dist_2=w_dist_2)
        data = self.encode_z2(x, self.encode_z1(x).replace(probs=probs))
        return self.decode(data.replace(z1=data.mu1, z2=data.p_mu2 + data.d_mu2), codebook)

    def generate_discrete_latent_space(
        self,
        codebook: torch.Tensor,
        z1_bias: float | torch.Tensor = 0.0,
        batch_size: int = 1,
        probs: torch.Tensor | None = None,
        noise: GenerationNoise | None = None,
        generator: torch.Generator | None = None,
    ) -> Outputs:
        """Sample z1 and z2 from the priors and decode to code indices
        (``w_autoencoders.py:195-212``): ``z1`` the prior's sample
        (:meth:`sample_z1_prior`) plus ``z1_bias`` (a float, or a tensor broadcast to ``(B, n_codes,
        z1_dim)``, which gives z1 a row per code), the class probabilities
        ``probs`` or the prior's draw, ``z2 = ε · exp(½ log σ²) + μ`` from
        the conditional prior.  ``noise`` holds the draws (see
        :meth:`sample_noise`); drawn from ``generator`` where not given."""
        if noise is None:
            if generator is None:
                raise ValueError('generation: pass the noise or a torch.Generator to draw it')
            noise = self.sample_noise(batch_size, generator)
        dev = codebook.device
        eps1, eps2, prior_probs, *which = (x.to(dev) for x in noise)
        z1 = self.sample_z1_prior(draws=(eps1, *which)) + (z1_bias.to(dev) if isinstance(z1_bias, torch.Tensor)
                                                           else z1_bias)
        probs = prior_probs if probs is None else probs.to(dev)
        p_mu2, p_log_var2 = self.z2_prior(probs).chunk(2, dim=2)
        z2 = eps2 * torch.exp(0.5 * p_log_var2) + p_mu2
        return self.decode(Outputs(z1=z1, z2=z2, probs=probs), codebook)

    def sample_noise(self, batch_size: int, generator: torch.Generator) -> GenerationNoise:
        """The draws of :meth:`generate_discrete_latent_space` on the
        generator's device, made in JAX's order (z1's draws, see
        :meth:`z1_draws`; the class probabilities ``(B, n_classes)``; z2's
        standard normal ``(B, n_codes, z2_dim)``) and returned as ``(z1's
        standard normal, z2's, the probabilities)``, with the chosen
        pseudo-inputs last where the model has them
        (:func:`pccf_torch.host.generation_noise`, which an exported
        artifact draws without the model)."""
        return host.generation_noise(batch_size, generator, n_codes=self.n_codes, z1_dim=self.z1_dim,
                                     z2_dim=self.z2_dim, n_classes=self.n_classes, conditional=self.conditional,
                                     n_pseudo_inputs=self.n_pseudo_inputs)

    def z1_draws(self, batch_size: int, generator: torch.Generator) -> tuple[torch.Tensor, ...]:
        """The draws of z1's prior: a standard normal ``(B, 1, z1_dim)``; with
        pseudo-inputs, a standard normal ``(B, n_codes, z1_dim)`` and the
        pseudo-input each sample is drawn from ``(B,)`` (JAX draws the
        choice first)."""
        return host.z1_draws(batch_size, generator, self.n_codes, self.z1_dim, self.n_pseudo_inputs)

    def sample_z1_prior(self, batch_size: int = 1, generator: torch.Generator | None = None,
                        draws: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
        """A sample of z1's prior (``w_autoencoders.py:214-223``): the standard
        normal ``(B, 1, z1_dim)``, or with pseudo-inputs the VampPrior's
        ``ε · exp(½ log σ²) + μ`` of the chosen pseudo-inputs' z1 statistics,
        ``(B, n_codes, z1_dim)``.  ``draws`` (:meth:`z1_draws`) are drawn from
        ``generator`` when not given."""
        if draws is None:
            if generator is None:
                raise ValueError('sample_z1_prior: pass the draws or a torch.Generator to draw them')
            draws = self.z1_draws(batch_size, generator)
        if self.n_pseudo_inputs == 0:
            return draws[0]
        eps, which = draws
        pseudo = self.encode_z1(None)
        which = which.long()
        return eps * torch.exp(0.5 * pseudo.pseudo_log_var1[which]) + pseudo.pseudo_mu1[which]

    def sample_prob(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """Class probabilities ``(B, n_classes)`` (``w_autoencoders.py:225-231``,
        :func:`pccf_torch.host.class_probs`): Dirichlet(1) for the
        conditional model, else uniform."""
        return host.class_probs(batch_size, generator, self.n_classes, self.conditional)

    def fused_ok(self) -> bool:
        """``_fused_cf_ok`` (``w_autoencoders.py:115-148``): transformer nets
        with the exact GELU and one shared ``proj_dim``, and the shape test of
        ``cvae_cf_supported`` (``pallas_cvae.py:58-74``): tokens and width in
        multiples of 128, whole heads in each net, a code embedding of at most
        128.  Pseudo-inputs do not gate it (their rows are split off before
        the counterfactual reads z1).  The VMEM budget is a TPU limit and is
        not carried over; inside the gate the card's chain covers every shape
        but heads wider than 128, which raise ``ValueError`` before any
        launch."""
        enc, post, dec = self.encoder, self.z2_posterior, self.decoder
        return (
            isinstance(enc, TransformerWEncoder)
            and isinstance(post, TransformerWConditionalEncoder)
            and isinstance(dec, TransformerWDecoder)
            and all(net.act is gelu_exact for net in (enc, post, dec))
            and enc.proj_dim == post.proj_dim == dec.proj_dim
            and self.n_codes % 128 == 0
            and enc.proj_dim % 128 == 0
            and self.embedding_dim <= MAX_EMBEDDING
            and all(enc.proj_dim % net.n_heads == 0 for net in (enc, post, dec))
        )


class WAETrainModule(nn.Module):
    """Stage-2 training shell (``w_autoencoders.py:233-249``): the inner CVAE
    and the VQ-VAE's codebook as a buffer, which the optimiser neither trains
    nor decays."""

    def __init__(self, wae: WAutoEncoder, book_size: int) -> None:
        super().__init__()
        self.wae = wae
        self.register_buffer('codebook', torch.zeros(wae.n_codes, book_size, wae.embedding_dim))

    def forward(self, inputs: WInputs, eps: Noise | None = None, generator: torch.Generator | None = None) -> Outputs:
        return self.wae(inputs, self.codebook, eps, generator)


def build_w_autoencoder(cfg: SliceConfig) -> WAutoEncoder:
    """The inner CVAE of the configuration, each net from its factory
    (``w_autoencoders.py:280-300``)."""
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    return WAutoEncoder(
        encoder=get_w_encoder(cfg),
        decoder=get_w_decoder(cfg),
        z2_prior=ConditionalPrior(cfg.data.n_classes, ae.n_codes, wae.z2_dim),
        z2_posterior=get_conditional_w_encoder(cfg),
        n_codes=ae.n_codes,
        embedding_dim=ae.embedding_dim,
        z1_dim=wae.z1_dim,
        z2_dim=wae.z2_dim,
        n_classes=cfg.data.n_classes,
        cf_temperature=wae.cf_temperature,
        conditional=ae.class_name == 'CounterfactualVQVAE',
        n_pseudo_inputs=wae.n_pseudo_inputs,
    )

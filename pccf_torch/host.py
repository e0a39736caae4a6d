"""The host side of serving that the live server
(:mod:`pccf_torch.serve`) and an exported artifact
(:mod:`pccf_torch.export`) share: the buckets a request is padded to, and
the draws a request's seeds make on the host.

A counterfactual request's decoder scaffold ``initial_sampling`` comes from
one ``torch.Generator`` a request, seeded by (server seed, request seed); a
generation chunk's latent draws and scaffold come from one generator seeded
by (server seed, seed, chunk) under generation's own spawn key.  The numbers
differ from JAX's ``fold_in`` draws.  Both sides draw here, so an artifact
reproduces the live server on the same device for the same seeds.

This module imports torch and numpy alone: the artifact loader runs without
the model code.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# the spawn key of generation's seed sequences: their entropy is then longer
# than any request's (server seed, request seed), so the streams of the two
# never coincide
GENERATION_STREAM = 1


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def pad_batch(x: np.ndarray, b: int) -> np.ndarray:
    if x.shape[0] == b:
        return x
    return np.pad(x, [(0, b - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def host_generator(entropy: list[int], spawn_key: tuple[int, ...] = ()) -> torch.Generator:
    state = np.random.SeedSequence(entropy, spawn_key=spawn_key).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def initial_sampling(seed: int, seeds: Sequence[int], n_out: int, sample_dim: int) -> torch.Tensor:
    """``(len(seeds), n_out, sample_dim)`` on the host: each request's
    scaffold from its own generator, seeded by (server seed, request seed)."""
    return torch.stack([torch.randn((n_out, sample_dim), generator=host_generator([seed, int(s)])) for s in seeds])


def z1_draws(batch_size: int, generator: torch.Generator, n_codes: int, z1_dim: int,
             n_pseudo_inputs: int = 0) -> tuple[torch.Tensor, ...]:
    """The draws of z1's prior on the generator's device: a standard normal
    ``(B, 1, z1_dim)``; with pseudo-inputs, the pseudo-input each sample is
    drawn from ``(B,)`` (JAX draws the choice first) and a standard normal
    ``(B, n_codes, z1_dim)``, returned as ``(normal, choice)``."""
    dev = generator.device
    if n_pseudo_inputs == 0:
        return (torch.randn((batch_size, 1, z1_dim), generator=generator, device=dev),)
    which = torch.randint(0, n_pseudo_inputs, (batch_size,), generator=generator, device=dev)
    return torch.randn((batch_size, n_codes, z1_dim), generator=generator, device=dev), which


def class_probs(batch_size: int, generator: torch.Generator, n_classes: int, conditional: bool) -> torch.Tensor:
    """Class probabilities ``(B, n_classes)`` (``w_autoencoders.py:225-231``):
    Dirichlet(1) for the conditional model, else uniform.  With every
    concentration 1 the Dirichlet is i.i.d. Exp(1) draws divided by their
    sum, drawn with ``exponential_`` because
    ``torch.distributions.Dirichlet.sample`` takes no generator."""
    if not conditional:
        return torch.full((batch_size, n_classes), 1.0 / n_classes, device=generator.device)
    e = torch.empty((batch_size, n_classes), device=generator.device).exponential_(generator=generator)
    return e / e.sum(dim=1, keepdim=True)


def generation_noise(batch_size: int, generator: torch.Generator, *, n_codes: int, z1_dim: int, z2_dim: int,
                     n_classes: int, conditional: bool, n_pseudo_inputs: int = 0) -> tuple[torch.Tensor, ...]:
    """Generation's latent draws in JAX's order (z1's, the class
    probabilities, z2's standard normal ``(B, n_codes, z2_dim)``), returned
    as ``(z1's standard normal, z2's, the probabilities)`` with the chosen
    pseudo-inputs last where the model has them."""
    z1 = z1_draws(batch_size, generator, n_codes, z1_dim, n_pseudo_inputs)
    probs = class_probs(batch_size, generator, n_classes, conditional)
    eps2 = torch.randn((batch_size, n_codes, z2_dim), generator=generator, device=generator.device)
    return (z1[0], eps2, probs, *z1[1:])


def generation_generator(seed: int, request_seed: int, chunk: int) -> torch.Generator:
    """The host generator of one generation chunk."""
    return host_generator([seed, int(request_seed), int(chunk)], (GENERATION_STREAM,))

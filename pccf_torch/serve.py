"""Counterfactual serving on one device (``pccf/serve.py``).

Kept from the JAX server:

- :meth:`CounterfactualServer.classify` and
  :meth:`CounterfactualServer.counterfactual`, with request batches padded to
  the smallest bucket that fits (oversize batches run in bucket-size chunks);
- per-request determinism (``serve.py:23-26``): the decoder's
  ``initial_sampling`` of each request is drawn from a ``torch.Generator``
  seeded by ``(server seed, request seed)``, so a request's output does not
  depend on how it was batched or padded.  The numbers differ from JAX's
  ``fold_in`` draws.
- the weights the fused paths read are folded once, when the server starts
  (the ``packed`` cache of ``serve.py:315-328``).

Microbatching, the asynchronous path, the mesh and the bf16 weight cast are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pccf_torch.data.structures import Inputs

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def pad_batch(x: np.ndarray, b: int) -> np.ndarray:
    if x.shape[0] == b:
        return x
    return np.pad(x, [(0, b - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


class CounterfactualServer:
    """Serve counterfactual generation (and classification) from a VQ-VAE and
    an optional classifier, both already on ``device``."""

    def __init__(
        self,
        vqvae,
        classifier=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        seed: int = 0,
    ) -> None:
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f'buckets must be ascending and unique, got {buckets}')
        self.buckets = tuple(int(b) for b in buckets)
        self.vqvae = vqvae.eval()
        self.classifier = classifier.eval() if classifier is not None else None
        self.device = vqvae.codebook.device
        self.seed = int(seed)
        self.n_out = int(vqvae.n_inference_output_points)
        self.sample_dim = int(vqvae.decoder.sample_dim)
        self.stats: dict[str, Any] = {'served': 0, 'batches': 0, 'padded': 0}
        vqvae.prepack()

    def _tensor(self, x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def initial_sampling(self, seeds: np.ndarray) -> torch.Tensor:
        """``(len(seeds), n_out, sample_dim)`` decoder scaffold, one generator
        per request seeded by (server seed, request seed)."""
        draws = []
        for s in seeds:
            state = np.random.SeedSequence([self.seed, int(s)]).generate_state(2, np.uint32)
            gen = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
            draws.append(torch.randn((self.n_out, self.sample_dim), generator=gen))
        return torch.stack(draws).to(self.device)

    @torch.inference_mode()
    def classify(self, clouds: np.ndarray) -> np.ndarray:
        """Logits ``(B, n_classes)`` for a batch of clouds."""
        if self.classifier is None:
            raise ValueError('server built without a classifier')
        clouds = np.asarray(clouds, np.float32)
        b = next_bucket(clouds.shape[0], self.buckets)
        if clouds.shape[0] > b:
            return np.concatenate([self.classify(clouds[i : i + b]) for i in range(0, clouds.shape[0], b)])
        logits = self.classifier(Inputs(cloud=self._tensor(pad_batch(clouds, b))))
        return logits[: clouds.shape[0]].float().cpu().numpy()

    @torch.inference_mode()
    def counterfactual(
        self,
        clouds: np.ndarray,
        target_dim: int | np.ndarray,
        logits: np.ndarray | None = None,
        target_value: float | np.ndarray = 1.0,
        sampling_seed: int | np.ndarray = 0,
    ) -> np.ndarray:
        """Counterfactual reconstructions ``(B, n_out, 3)``.

        ``target_dim`` / ``target_value`` / ``sampling_seed`` may be scalars or
        per-sample arrays; without ``logits`` the server's classifier gives
        them.  The same request gives the same output however it is batched."""
        clouds = np.asarray(clouds, np.float32)
        n = clouds.shape[0]
        if logits is None:
            logits = self.classify(clouds)
        logits = np.asarray(logits, np.float32)
        tdim = np.broadcast_to(np.asarray(target_dim, np.int64), (n,))
        tval = np.broadcast_to(np.asarray(target_value, np.float32), (n,))
        seeds = np.broadcast_to(np.asarray(sampling_seed, np.int64), (n,))
        b = next_bucket(n, self.buckets)
        parts = []
        for i in range(0, n, b):
            m = min(b, n - i)
            out = self.vqvae.generate_counterfactual(
                Inputs(
                    cloud=self._tensor(pad_batch(clouds[i : i + b], b)),
                    initial_sampling=self.initial_sampling(pad_batch(seeds[i : i + b], b)),
                ),
                self._tensor(pad_batch(logits[i : i + b], b)),
                self._tensor(pad_batch(tdim[i : i + b], b), torch.int64),
                self._tensor(pad_batch(tval[i : i + b], b)[:, None]),
            )
            parts.append(out.recon[:m].float().cpu().numpy())
            self.stats['served'] += m
            self.stats['batches'] += 1
            self.stats['padded'] += b - m
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

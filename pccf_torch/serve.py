"""Counterfactual serving on one device (``pccf/serve.py``).

Kept from the JAX server:

- :meth:`CounterfactualServer.classify` and
  :meth:`CounterfactualServer.counterfactual`, with request batches padded to
  the smallest bucket that fits, ``(1, 2, 4, 8, 16, 32, 64)`` by default
  (oversize batches run in bucket-size chunks);
- per-request determinism (``serve.py:23-26``): the decoder's
  ``initial_sampling`` of each request is drawn from a ``torch.Generator``
  seeded by ``(server seed, request seed)``, so a request's output does not
  depend on how it was batched or padded.  The numbers differ from JAX's
  ``fold_in`` draws.  The buckets and the draws live in :mod:`pccf_torch.host`,
  which an exported artifact (:mod:`pccf_torch.export`) draws from too.
- :meth:`CounterfactualServer.counterfactual_async`, which dispatches every
  chunk, schedules each result's copy into pinned host memory and returns a
  :class:`ServeFuture` without waiting; :meth:`counterfactual` is its
  ``result()``;
- :meth:`CounterfactualServer.generate`, samples from the generative prior,
  deterministic per (bucket, seed, chunk);
- microbatching: single clouds queued by :meth:`submit` run as one batch in
  :meth:`flush`, which may be called from another thread;
- :meth:`CounterfactualServer.warmup`, which drives every entry point once
  per bucket and leaves ``stats`` as they were;
- the weights the fused paths read are folded once, when the server starts
  (the ``packed`` cache of ``serve.py:315-328``);
- the opt-in bf16 weight cast (``cast_bf16``, ``serve.py:92-93, 216-220``):
  the server serves a copy of the models whose float32 parameters and
  buffers (BatchNorm statistics and the codebook included) are rounded to
  bfloat16 and held so on the device (:func:`bf16_copy`); the caller's
  models stay float32.  A module reads each one widened to float32 through a
  parametrisation, so the activations and the arithmetic stay float32 on
  the rounded values, as JAX's cast computes on the CPU (an f32 activation
  and a bf16 parameter promote to f32).  The stacks' matrices stay bf16 in
  the CVAE chain's pack and the W-decoder's, and the card's GEMM reads them
  through its bf16-weight instance; the folds (the chain's head products,
  PCGen's BatchNorm folds) are computed in float32 from the rounded values.
  Arithmetic on parameters alone is bf16 in JAX's cast (all its operands are
  bf16); where its compiled graph rounds it, BatchNorm's ``rsqrt(σ² + ε)``,
  the port rounds it too (:meth:`pccf_torch.nn.layers.BatchNorm.scale`);
- data-parallel serving (``devices=``, the counterpart of ``mesh=``,
  ``serve.py:80-136``): each listed device holds a replica of the served
  models (after the cast, prepacked), every bucket is cut into contiguous
  shards of ``bucket / len(devices)`` rows, one a replica, and the results
  come back in row order.  A device may be listed twice (two replicas on
  it).  Buckets that the device count does not divide raise.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, Sequence

import numpy as np
import torch
from torch.nn.utils import parametrize

from pccf_torch import host
from pccf_torch.data.structures import Inputs
from pccf_torch.host import DEFAULT_BUCKETS, next_bucket, pad_batch
from pccf_torch.models.w_autoencoders import GenerationNoise

__all__ = ['DEFAULT_BUCKETS', 'CounterfactualServer', 'ServeFuture', 'bf16_copy', 'next_bucket', 'on_device',
           'pad_batch', 'stored_dtypes']


class _Widen(torch.nn.Module):
    """What a module reads of a tensor the cast stores in bf16: its float32
    value, exactly."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()


def bf16_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` in eval whose float32 parameters and buffers are
    rounded to bfloat16 and stored so (``pccf/serve.py:216-220`` ``_cast``),
    each behind a widening parametrisation: ``module.weight`` reads float32,
    ``parametrizations.weight.original`` holds the bf16 values, and nothing
    else keeps a float32 copy.  Folded packs are dropped from the copy, to
    be folded again from the rounded values.  ``model`` is left as it was."""
    model = copy.deepcopy(model).eval()
    for module in list(model.modules()):
        if getattr(module, 'packed', None) is not None:
            module.packed = None
        for kind in ('_parameters', '_buffers'):
            for name, t in list(getattr(module, kind).items()):
                if t is None or t.dtype != torch.float32:
                    continue
                rounded = t.detach().to(torch.bfloat16)
                if kind == '_parameters':
                    module._parameters[name] = torch.nn.Parameter(rounded, requires_grad=False)
                else:
                    module._buffers[name] = rounded
                parametrize.register_parametrization(module, name, _Widen(), unsafe=True)
    return model


def stored_dtypes(model: torch.nn.Module) -> set[torch.dtype]:
    """The types of the floating-point tensors ``model`` stores, parameters
    and buffers: ``{torch.bfloat16}`` for a :func:`bf16_copy`."""
    return {t.dtype for t in (*model.parameters(), *model.buffers()) if t.is_floating_point()}


def on_device(device: torch.device) -> contextlib.AbstractContextManager:
    """``device`` as the current card, nothing on the CPU: a kernel launches
    on the current card's stream, so a replica's work runs under its card."""
    return torch.cuda.device(device) if device.type == 'cuda' else contextlib.nullcontext()


class ServeFuture:
    """An in-flight counterfactual request: each chunk's recon on the device,
    its copy into pinned host memory and the event recorded after that copy
    (none on the CPU, where the parts are ready at once).  :meth:`result`
    waits for the events and concatenates the chunks in request order; the
    future holds the device tensors and the host buffers until then."""

    def __init__(self, parts: list[tuple[torch.Tensor, torch.Tensor, torch.cuda.Event | None]]) -> None:
        self._parts = parts  # [(device recon of the valid rows, host copy, event), ...]

    def result(self) -> np.ndarray:
        outs = []
        for _, host, event in self._parts:
            if event is not None:
                event.synchronize()
            outs.append(host.numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs)


class CounterfactualServer:
    """Serve counterfactual generation (and classification) from a VQ-VAE and
    an optional classifier, both already on ``device``.  ``classify``,
    ``counterfactual``, ``generate``, ``submit`` and ``flush`` may be called
    from several threads; each public method runs in inference mode on the
    thread that calls it (PyTorch keeps that mode per thread).  With
    ``cast_bf16`` the server serves :func:`bf16_copy` of both models.  With
    ``devices`` it serves a replica of them on each device, each bucket
    sharded over the replicas by rows; the caller's models are left where
    they are."""

    def __init__(
        self,
        vqvae,
        classifier=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        seed: int = 0,
        cast_bf16: bool = False,
        devices: Sequence[torch.device | str] | None = None,
    ) -> None:
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f'buckets must be ascending and unique, got {buckets}')
        self.buckets = tuple(int(b) for b in buckets)
        if devices is not None:
            bad = [b for b in self.buckets if b % len(devices)]
            if not devices or bad:
                raise ValueError(f'buckets {bad} are not divisible by the {len(devices)} devices')
        self.cast_bf16 = bool(cast_bf16)
        if self.cast_bf16:
            vqvae = bf16_copy(vqvae)
            classifier = bf16_copy(classifier) if classifier is not None else None
        # (vqvae, classifier) per replica; one replica: the models as given
        self.replicas = [(vqvae.eval(), classifier.eval() if classifier is not None else None)] if devices is None \
            else [(copy.deepcopy(vqvae).to(d).eval(),
                   copy.deepcopy(classifier).to(d).eval() if classifier is not None else None) for d in devices]
        self.vqvae, self.classifier = self.replicas[0]
        self.device = self.vqvae.codebook.device
        self.seed = int(seed)
        self.n_out = int(vqvae.n_inference_output_points)
        self.sample_dim = int(vqvae.decoder.sample_dim)
        # guards ticket minting and the queue: flush() serves a snapshot
        # while submits from other threads land
        self._queue: list[tuple[int, np.ndarray, np.ndarray | None, int, float, int]] = []
        self._next_ticket = 0
        self._queue_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats: dict[str, Any] = {'served': 0, 'batches': 0, 'padded': 0}
        for vqvae, classifier in self.replicas:
            with on_device(vqvae.codebook.device):
                vqvae.prepack()
            if self.cast_bf16:
                # never an f32 server under the cast's name
                for name, model in (('vqvae', vqvae), ('classifier', classifier)):
                    if model is not None and stored_dtypes(model) - {torch.bfloat16}:
                        raise RuntimeError(f'cast_bf16: the {name} stores {stored_dtypes(model)}')
                pack = vqvae.w_autoencoder.packed
                if pack is not None and not pack.bf16:
                    raise RuntimeError('cast_bf16: the CVAE chain packed fp32 stack weights')

    @classmethod
    def from_config(cls, cfg, device: torch.device | str, **kwargs) -> 'CounterfactualServer':
        """A server of the models in the current experiment's checkpoints,
        loaded as the evaluation entry points load them (``serve.py:222-231``),
        on ``device``; ``devices=`` in ``kwargs`` replicates them there."""
        from pccf_torch.train.w_autoencoder import load_models

        classifier, vqvae = load_models(cfg, torch.device(device))
        return cls(vqvae, classifier, **kwargs)

    def _to_device(self, t: torch.Tensor, device: torch.device | None = None) -> torch.Tensor:
        """Move a host tensor to ``device`` (the server's by default); to the
        card through pinned memory without waiting (a pageable source would
        wait for the device work already queued)."""
        device = self.device if device is None else device
        if device.type == 'cuda' and t.device.type == 'cpu':
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def _tensor(self, x: np.ndarray, dtype: np.dtype = np.float32, device: torch.device | None = None) -> torch.Tensor:
        return self._to_device(torch.from_numpy(np.array(x, dtype=dtype)), device)

    def _shards(self, b: int) -> list[tuple[torch.nn.Module, torch.nn.Module | None, torch.device, slice]]:
        """Each replica's models, device and contiguous rows of a bucket of ``b``."""
        size = b // len(self.replicas)
        return [(vq, cls, vq.codebook.device, slice(i * size, (i + 1) * size))
                for i, (vq, cls) in enumerate(self.replicas)]

    def initial_sampling(self, seeds: np.ndarray) -> torch.Tensor:
        """``(len(seeds), n_out, sample_dim)`` decoder scaffold, one generator
        per request seeded by (server seed, request seed)."""
        return self._to_device(host.initial_sampling(self.seed, seeds, self.n_out, self.sample_dim))

    def generation_draws(self, b: int, seed: int, chunk: int) -> tuple[GenerationNoise, torch.Tensor]:
        """The latent draws and the decoder scaffold of one generation chunk
        at bucket ``b``, on the host from one generator seeded by (server
        seed, seed, chunk) under generation's own spawn key."""
        gen = host.generation_generator(self.seed, seed, chunk)
        noise = self.vqvae.w_autoencoder.sample_noise(b, gen)
        return noise, torch.randn((b, self.n_out, self.sample_dim), generator=gen)

    def _bump_stats(self, n: int, b: int) -> None:
        # read-modify-write on plain ints: concurrent requests would undercount
        with self._stats_lock:
            self.stats['served'] += n
            self.stats['batches'] += 1
            self.stats['padded'] += b - n

    # ------------------------------------------------------------- direct
    @torch.inference_mode()
    def classify(self, clouds: np.ndarray) -> np.ndarray:
        """Logits ``(B, n_classes)`` for a batch of clouds."""
        if self.classifier is None:
            raise ValueError('server built without a classifier')
        clouds = np.asarray(clouds, np.float32)
        b = next_bucket(clouds.shape[0], self.buckets)
        if clouds.shape[0] > b:
            return np.concatenate([self.classify(clouds[i : i + b]) for i in range(0, clouds.shape[0], b)])
        padded = pad_batch(clouds, b)
        # every replica's launches first, then the copies: the devices overlap
        logits = []
        for _, cls, dev, rows in self._shards(b):
            with on_device(dev):
                logits.append(cls(Inputs(cloud=self._tensor(padded[rows], device=dev))))
        return torch.cat([x.float().cpu() for x in logits])[: clouds.shape[0]].numpy()

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
        return self.counterfactual_async(clouds, target_dim, logits, target_value, sampling_seed).result()

    @torch.inference_mode()
    def counterfactual_async(
        self,
        clouds: np.ndarray,
        target_dim: int | np.ndarray,
        logits: np.ndarray | None = None,
        target_value: float | np.ndarray = 1.0,
        sampling_seed: int | np.ndarray = 0,
    ) -> ServeFuture:
        """Dispatch a counterfactual request without waiting for the device:
        every bucket-size chunk is launched up front (its inputs copied to the
        card from pinned memory), and on the card its result is copied into
        pinned host memory behind an event.  Keeping
        two or more requests in flight overlaps one request's host work with
        the device work of the one before.  Without ``logits`` the
        classification still waits for its result."""
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
            chunk = [pad_batch(x[i : i + b], b) for x in (clouds, seeds, logits, tdim, tval)]
            for vq, _, dev, rows in self._shards(b):
                valid = min(max(m - rows.start, 0), rows.stop - rows.start)
                if valid == 0:
                    continue
                c, s, lg, td, tv = (x[rows] for x in chunk)
                with on_device(dev):
                    out = vq.generate_counterfactual(
                        Inputs(cloud=self._tensor(c, device=dev),
                               initial_sampling=self._to_device(self.initial_sampling(s), dev)),
                        self._tensor(lg, device=dev),
                        self._tensor(td, np.int64, dev),
                        self._tensor(tv[:, None], device=dev),
                    )
                    parts.append(self._fetch(out.recon[:valid].float()))
            self._bump_stats(m, b)
        return ServeFuture(parts)

    @staticmethod
    def _fetch(recon: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.cuda.Event | None]:
        """Schedule the copy of ``recon`` to the host: into a pinned buffer
        behind an event on the card (a pageable destination would make the
        copy synchronous), none on the CPU."""
        if not recon.is_cuda:
            return recon, recon, None
        host = torch.empty(recon.shape, dtype=recon.dtype, pin_memory=True)
        host.copy_(recon, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return recon, host, event

    # --------------------------------------------------------- generation
    @torch.inference_mode()
    def generate(
        self,
        n: int,
        z1_bias: float = 0.0,
        probs: np.ndarray | None = None,
        seed: int = 0,
    ) -> np.ndarray:
        """``n`` clouds ``(n, n_out, 3)`` sampled from the generative prior
        (``generate.py``'s path), the class probabilities ``probs (n,
        n_classes)`` or the prior's draw.  Deterministic per (bucket, seed,
        chunk); pass distinct seeds for distinct draws.  An oversize ``n``
        runs in chunks of the largest bucket."""
        b = next_bucket(n, self.buckets)
        if n > b:
            return np.concatenate([
                self._generate_chunk(min(b, n - i), z1_bias, None if probs is None else probs[i : i + b], seed,
                                     i // b)
                for i in range(0, n, b)
            ])
        return self._generate_chunk(n, z1_bias, probs, seed, 0)

    def _generate_chunk(self, n: int, z1_bias: float, probs: np.ndarray | None, seed: int, chunk: int) -> np.ndarray:
        """One chunk: the draws at the bucket's size, cut to ``n``."""
        b = next_bucket(n, self.buckets)
        noise, sampling = self.generation_draws(b, seed, chunk)
        p = None if probs is None else pad_batch(np.asarray(probs, np.float32), b)
        recon = []
        for vq, _, dev, rows in self._shards(b):
            with on_device(dev):
                recon.append(vq.generate(rows.stop - rows.start, self._to_device(sampling[rows], dev), float(z1_bias),
                                         None if p is None else self._tensor(p[rows], device=dev),
                                         tuple(self._to_device(x[rows], dev) for x in noise)).recon)
        self._bump_stats(n, b)
        return torch.cat([x.float().cpu() for x in recon])[:n].numpy()

    # ------------------------------------------------------ microbatching
    @torch.inference_mode()
    def submit(
        self,
        cloud: np.ndarray,
        target_dim: int,
        logits: np.ndarray | None = None,
        target_value: float = 1.0,
        sampling_seed: int = 0,
    ) -> int:
        """Queue one cloud ``(N, 3)``; returns a ticket for :meth:`flush`."""
        cloud = np.asarray(cloud, np.float32)
        if cloud.ndim != 2 or cloud.shape[-1] != 3:
            raise ValueError(f'cloud must be (N, 3), got {cloud.shape}')
        if logits is None and self.classifier is None:
            # a logits-less entry would make every later flush raise
            raise ValueError('server built without a classifier: submit() requires logits')
        with self._queue_lock:
            if self._queue and cloud.shape != self._queue[0][1].shape:
                raise ValueError(f'cloud shape {cloud.shape} differs from queued {self._queue[0][1].shape}; '
                                 f'flush() before switching shapes')
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append((ticket, cloud, logits, int(target_dim), float(target_value), int(sampling_seed)))
        return ticket

    @torch.inference_mode()
    def flush(self) -> dict[int, np.ndarray]:
        """Serve the queued requests as one batch; returns ticket -> recon.
        The classifier fills only the logits that are missing."""
        with self._queue_lock:  # a snapshot: submits landing mid-flush stay queued
            queue = list(self._queue)
        if not queue:
            return {}
        clouds = np.stack([q[1] for q in queue])
        tdim = np.asarray([q[3] for q in queue], np.int64)
        tval = np.asarray([q[4] for q in queue], np.float32)
        seeds = np.asarray([q[5] for q in queue], np.int64)
        missing = [i for i, q in enumerate(queue) if q[2] is None]
        given = [i for i, q in enumerate(queue) if q[2] is not None]
        if missing:
            computed = self.classify(clouds[missing])
            logits = np.empty((len(queue), computed.shape[1]), np.float32)
            logits[missing] = computed
            if given:
                logits[given] = np.stack([np.asarray(queue[i][2], np.float32) for i in given])
        else:
            logits = np.stack([np.asarray(q[2], np.float32) for q in queue])
        recon = self.counterfactual(clouds, tdim, logits, tval, seeds)
        # drain the snapshot only after success, by ticket: a failed flush
        # keeps its tickets, and a concurrent flush may have drained this
        # snapshot already while new requests landed
        with self._queue_lock:
            served = {q[0] for q in queue}
            self._queue = [q for q in self._queue if q[0] not in served]
        return {q[0]: recon[i] for i, q in enumerate(queue)}

    # ------------------------------------------------------------- warmup
    @torch.inference_mode()
    def warmup(
        self,
        n_points: int,
        n_classes: int,
        buckets: Sequence[int] | None = None,
        generate: bool = True,
    ) -> None:
        """Drive every entry point once per bucket (default: all):
        counterfactual, classification when a classifier is present, and
        generation with and without ``probs``.  On the card the first call
        builds the kernels and loads their library.  Leaves ``stats`` as
        they were: its synthetic traffic is not served traffic."""
        with self._stats_lock:
            before = dict(self.stats)
        for b in buckets or self.buckets:
            cloud = np.zeros((b, n_points, 3), np.float32)
            self.counterfactual(cloud, 0, np.zeros((b, n_classes), np.float32), 1.0)
            if self.classifier is not None:
                self.classify(cloud)
            if generate:
                self.generate(b)
                self.generate(b, probs=np.full((b, n_classes), 1.0 / n_classes, np.float32))
        with self._stats_lock:
            self.stats.update(before)

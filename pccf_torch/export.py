"""Serving artifacts: the server's endpoints as ``torch.export`` programs
(``pccf/export.py``).

A trained :class:`~pccf_torch.serve.CounterfactualServer` is exported as
self-contained programs, the weights and the folded packs held in them as
constants, that run with ``torch`` and the kernels' op registry
(:mod:`pccf_torch.kernels.library`) alone: no model code, no configuration,
no checkpoint.

- **One program per (endpoint, platform)**, a ``.pt2`` file each, and a
  ``manifest.json`` with the JAX manifest's keys and what the loader needs
  to draw a request's noise.  The platforms are ``cuda`` and ``cpu``: every
  kernel the endpoints reach is a ``torch.ops.pccf`` custom op that
  dispatches by device, so a ``cuda`` program launches the hand-written
  kernels and a ``cpu`` program runs their plain versions.  A ``cpu``
  artifact of a card server is exported from a CPU copy of its models.
- **A symbolic batch** first (``torch.export.Dim``): one program serves
  every bucket.  Where the trace refuses it, one program per bucket,
  a warning, and the reason under ``poly_error``, as ``pccf/export.py:72-101``.
- **The noise is an input.**  The port draws a request's noise on the host
  (:mod:`pccf_torch.host`), so the exported ``counterfactual`` takes the
  decoder scaffold ``initial_sampling`` and the exported ``generate`` takes
  the latent draws and the scaffold; :class:`ServingArtifact` draws them as
  the live server does, and an artifact reproduces the live server on the
  same device for the same ``(server seed, request seed)``.
- A ``cast_bf16`` server exports its bf16 copy, as JAX's export of a cast
  server bakes the cast variables.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from pccf_torch import host
from pccf_torch.data.structures import Inputs
from pccf_torch.kernels import library  # noqa: F401  (registers the torch.ops.pccf ops the programs call)

logger = logging.getLogger(__name__)

MANIFEST = 'manifest.json'
PLATFORMS = ('cuda', 'cpu')


def current_platform() -> str:
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def _check_platform(platform: str) -> None:
    can = [p for p in PLATFORMS if p != 'cuda' or torch.cuda.is_available()]
    if platform not in can:
        raise ValueError(f'cannot export for platform {platform!r}: this machine can export for {can}')


# ------------------------------------------------------------------ programs


class _Classify(torch.nn.Module):
    def __init__(self, classifier: torch.nn.Module) -> None:
        super().__init__()
        self.classifier = classifier

    def forward(self, cloud: torch.Tensor) -> torch.Tensor:
        return self.classifier(Inputs(cloud=cloud)).float()


class _Counterfactual(torch.nn.Module):
    def __init__(self, vqvae: torch.nn.Module) -> None:
        super().__init__()
        self.vqvae = vqvae

    def forward(self, cloud, logits, target_dim, target_value, initial_sampling) -> torch.Tensor:
        out = self.vqvae.generate_counterfactual(Inputs(cloud=cloud, initial_sampling=initial_sampling), logits,
                                                 target_dim, target_value)
        return out.recon.float()


class _Generate(torch.nn.Module):
    def __init__(self, vqvae: torch.nn.Module) -> None:
        super().__init__()
        self.vqvae = vqvae

    def forward(self, initial_sampling, z1_bias, probs, eps1, eps2, which=None) -> torch.Tensor:
        noise = (eps1, eps2, probs) if which is None else (eps1, eps2, probs, which)
        return self.vqvae.generate(initial_sampling.shape[0], initial_sampling, z1_bias, probs, noise).recon.float()


def _models_on(server, platform: str) -> tuple[torch.nn.Module, torch.nn.Module | None]:
    """A copy of the server's (first replica's) models on ``platform``, its
    packs folded anew there: the trace swaps the traced module's parameters
    for fake tensors while it runs, and the live server keeps serving."""
    vqvae, classifier = server.vqvae, server.classifier
    vqvae = copy.deepcopy(vqvae).to(platform).eval()
    for module in vqvae.modules():
        if getattr(module, 'packed', None) is not None:
            module.packed = None
    vqvae.prepack()
    return vqvae, None if classifier is None else copy.deepcopy(classifier).to(platform).eval()


def _save(ep: torch.export.ExportedProgram, path: Path) -> None:
    """``torch.export.save``, refusing a constant that is a strided view: the
    archive writes a card tensor's elements packed and its strides as they
    were, which would read it back wrong."""
    views = [name for name, t in ep.constants.items() if isinstance(t, torch.Tensor) and not t.is_contiguous()]
    if views:
        raise ValueError(f'export: constants {views} are strided views; store them contiguous')
    torch.export.save(ep, path)


def _export_endpoint(module: torch.nn.Module, specs_of, batched: Sequence[bool], buckets: Sequence[int],
                     platform: str, out_dir: Path, name: str) -> dict[str, Any]:
    """Export ``module`` for ``platform``: a symbolic batch first, one program
    a bucket where that fails.  ``specs_of(b)`` gives example inputs at batch
    ``b``; ``batched`` marks the inputs whose first dimension is the batch."""
    t0 = time.perf_counter()
    top = max(2, max(buckets))
    batch = torch.export.Dim('batch', min=1, max=top)
    try:
        with torch.no_grad():
            ep = torch.export.export(module, specs_of(2),
                                     dynamic_shapes=tuple({0: batch} if b else None for b in batched))
        fname = f'{name}.{platform}.pt2'
        _save(ep, out_dir / fname)
        entry: dict[str, Any] = {'poly': fname}
        files = [fname]
    except Exception as e:  # noqa: BLE001 - any trace failure falls back, loudly and on record
        logger.warning('symbolic-batch export of %s for %s failed (%s: %.200s); falling back to per-bucket '
                       'artifacts', name, platform, type(e).__name__, e)
        entry = {'buckets': {}, 'poly_error': f'{type(e).__name__}: {str(e)[:200]}'}
        for b in buckets:
            with torch.no_grad():
                ep = torch.export.export(module, specs_of(int(b)))
            fname = f'{name}.{platform}.b{b}.pt2'
            _save(ep, out_dir / fname)
            entry['buckets'][str(int(b))] = fname
        files = list(entry['buckets'].values())
    entry['seconds'] = time.perf_counter() - t0
    entry['bytes'] = sum((out_dir / f).stat().st_size for f in files)
    return entry


def export_server(
    server,
    path: str | Path,
    n_points: int,
    n_classes: int,
    *,
    platforms: Sequence[str] | None = None,
    include_generate: bool = True,
) -> dict[str, Any]:
    """Export a :class:`~pccf_torch.serve.CounterfactualServer` to ``path``.

    Writes one ``.pt2`` file per (endpoint, platform) and a
    ``manifest.json``; returns the manifest.  ``n_points`` / ``n_classes``
    fix the non-batch input dimensions (``data.n_input_points`` and the
    dataset's class count).  ``platforms``: ``cuda``, ``cpu``; none or
    ``[]`` is the server's own device.  Each entry of the manifest's
    ``endpoints`` also holds the export's seconds and the files' bytes.

    Endpoints: ``counterfactual`` (cloud, logits, target_dim, target_value,
    initial_sampling), ``classify`` (when the server holds a classifier) and
    ``generate`` (initial_sampling, z1_bias, probs and the latent draws)
    unless disabled."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    platforms = tuple(platforms) if platforms else (server.device.type,)
    for platform in platforms:
        _check_platform(platform)
    wae = server.vqvae.w_autoencoder
    n_out, sample_dim = server.n_out, server.sample_dim
    dims = {'n_codes': int(wae.n_codes), 'z1_dim': int(wae.z1_dim), 'z2_dim': int(wae.z2_dim),
            'n_pseudo_inputs': int(wae.n_pseudo_inputs)}

    endpoints: dict[str, Any] = {}
    for platform in platforms:
        dev = torch.device(platform)
        vqvae, classifier = _models_on(server, platform)

        def f32(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def cf_specs(b):
            return (f32(b, n_points, 3), f32(b, n_classes), torch.zeros(b, dtype=torch.int64, device=dev),
                    f32(b, 1), f32(b, n_out, sample_dim))

        endpoints.setdefault('counterfactual', {})[platform] = _export_endpoint(
            _Counterfactual(vqvae), cf_specs, (True,) * 5, server.buckets, platform, path, 'counterfactual')
        if classifier is not None:
            endpoints.setdefault('classify', {})[platform] = _export_endpoint(
                _Classify(classifier), lambda b: (f32(b, n_points, 3),), (True,), server.buckets, platform, path,
                'classify')
        if include_generate:
            def gen_specs(b):
                noise = host.generation_noise(b, torch.Generator(), n_classes=n_classes,
                                              conditional=bool(wae.conditional), **dims)
                return (f32(b, n_out, sample_dim), f32(), *(x.to(dev) for x in noise[2:3] + noise[:2] + noise[3:]))

            batched = (True, False, True, True, True) + (True,) * (dims['n_pseudo_inputs'] > 0)
            endpoints.setdefault('generate', {})[platform] = _export_endpoint(
                _Generate(vqvae), gen_specs, batched, server.buckets, platform, path, 'generate')

    from pccf_torch.config import VERSION

    manifest = {
        'pccf_version': VERSION,
        'n_points': int(n_points),
        'n_out': int(n_out),
        'n_classes': int(n_classes),
        'buckets': [int(b) for b in server.buckets],
        'seed': int(server.seed),
        'conditional': bool(wae.conditional),
        'platforms': list(platforms),
        'endpoints': endpoints,
        'sample_dim': int(sample_dim),
        'cast_bf16': bool(server.cast_bf16),
        **dims,
    }
    (path / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


# -------------------------------------------------------------------- loader


class ServingArtifact:
    """Load and run exported endpoints: needs only ``torch``, numpy, the op
    registry and the artifact directory.

    Mirrors the :class:`~pccf_torch.serve.CounterfactualServer` call surface
    (numpy in and out, bucket padding, oversize chunking, per-sample
    targets) without importing any model code; it draws each request's
    noise as the live server does (:mod:`pccf_torch.host`)."""

    def __init__(self, path: str | Path, platform: str | None = None) -> None:
        self.path = Path(path)
        self.manifest = json.loads((self.path / MANIFEST).read_text())
        self.platform = platform or current_platform()
        if self.platform not in self.manifest['platforms']:
            raise ValueError(f'artifact was exported for {self.manifest["platforms"]}, '
                             f'current platform is {self.platform!r}')
        self.device = torch.device(self.platform)
        self.buckets = tuple(self.manifest['buckets'])
        self.seed = int(self.manifest['seed'])
        self._fns: dict[tuple[str, int | None], Any] = {}

    # ------------------------------------------------------------ internal
    def _entry(self, name: str) -> dict:
        try:
            return self.manifest['endpoints'][name][self.platform]
        except KeyError:
            raise ValueError(f'endpoint {name!r} not in artifact for {self.platform!r}') from None

    def program(self, name: str, b: int):
        """The exported program of endpoint ``name`` that serves bucket ``b``,
        loaded on first use; its inputs are on this artifact's device."""
        entry = self._entry(name)
        key = (name, None if 'poly' in entry else b)
        if key not in self._fns:
            fname = entry['poly'] if 'poly' in entry else entry['buckets'][str(b)]
            self._fns[key] = torch.export.load(self.path / fname).module()
        return self._fns[key]

    def _bucket(self, n: int) -> int:
        return host.next_bucket(n, self.buckets)

    def _tensor(self, x: np.ndarray, dtype=np.float32) -> torch.Tensor:
        t = torch.from_numpy(np.array(x, dtype=dtype))
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == 'cuda' else t

    @staticmethod
    def _numpy(out: torch.Tensor, n: int) -> np.ndarray:
        return out[:n].float().cpu().numpy()

    # ------------------------------------------------------------- public
    @torch.inference_mode()
    def classify(self, clouds: np.ndarray) -> np.ndarray:
        clouds = np.asarray(clouds, np.float32)
        n = clouds.shape[0]
        b = self._bucket(n)
        if n > b:
            return np.concatenate([self.classify(clouds[i: i + b]) for i in range(0, n, b)])
        return self._numpy(self.program('classify', b)(self._tensor(host.pad_batch(clouds, b))), n)

    @torch.inference_mode()
    def counterfactual(
        self,
        clouds: np.ndarray,
        target_dim: int | np.ndarray,
        logits: np.ndarray | None = None,
        target_value: float | np.ndarray = 1.0,
        sampling_seed: int | np.ndarray = 0,
    ) -> np.ndarray:
        clouds = np.asarray(clouds, np.float32)
        n = clouds.shape[0]
        if logits is None:
            logits = self.classify(clouds)
        logits = np.asarray(logits, np.float32)
        tdim = np.broadcast_to(np.asarray(target_dim, np.int64), (n,))
        tval = np.broadcast_to(np.asarray(target_value, np.float32), (n,))
        seeds = np.broadcast_to(np.asarray(sampling_seed, np.int64), (n,))
        b = self._bucket(n)
        outs = []
        for i in range(0, n, b):
            c, lg, td, tv, s = (host.pad_batch(x[i: i + b], b) for x in (clouds, logits, tdim, tval, seeds))
            sampling = host.initial_sampling(self.seed, s, self.manifest['n_out'], self.manifest['sample_dim'])
            out = self.program('counterfactual', b)(self._tensor(c), self._tensor(lg), self._tensor(td, np.int64),
                                                self._tensor(tv[:, None]), sampling.to(self.device))
            outs.append(self._numpy(out, min(b, n - i)))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    @torch.inference_mode()
    def generate(self, n: int, z1_bias: float = 0.0, probs: np.ndarray | None = None, seed: int = 0) -> np.ndarray:
        """``n`` clouds from the generative prior, the class probabilities
        ``probs (n, n_classes)`` or the prior's draw; deterministic per
        (bucket, seed, chunk), as the live server's."""
        b = self._bucket(n)
        if n > b:
            return np.concatenate([
                self._gen_chunk(min(b, n - i), z1_bias, None if probs is None else probs[i: i + b], seed, i // b)
                for i in range(0, n, b)
            ])
        return self._gen_chunk(n, z1_bias, probs, seed, 0)

    def _gen_chunk(self, n: int, z1_bias: float, probs: np.ndarray | None, seed: int, chunk: int) -> np.ndarray:
        m = self.manifest
        b = self._bucket(n)
        gen = host.generation_generator(self.seed, seed, chunk)
        noise = host.generation_noise(b, gen, n_codes=m['n_codes'], z1_dim=m['z1_dim'], z2_dim=m['z2_dim'],
                                      n_classes=m['n_classes'], conditional=m['conditional'],
                                      n_pseudo_inputs=m['n_pseudo_inputs'])
        sampling = torch.randn((b, m['n_out'], m['sample_dim']), generator=gen)
        given = noise[2] if probs is None else torch.from_numpy(host.pad_batch(np.asarray(probs, np.float32), b))
        out = self.program('generate', b)(sampling.to(self.device), torch.tensor(float(z1_bias), device=self.device),
                                      given.to(self.device), *(x.to(self.device) for x in noise[:2] + noise[3:]))
        return self._numpy(out, n)


def load_artifact(path: str | Path, platform: str | None = None) -> ServingArtifact:
    """Open an exported artifact directory for serving."""
    return ServingArtifact(path, platform)

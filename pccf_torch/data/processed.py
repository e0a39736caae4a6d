"""The datasets derived by the frozen models (``pccf/data/processed.py``).

Stage 2 trains the inner CVAE on what the frozen VQ-VAE and classifier make
of the point clouds (:class:`WDatasetWithLogits`: the encoder output
``w_q``, its quantisation ``w_e`` with the one-hot selections, and the
classifier's logits).  The evaluation suites classify clouds that the VQ-VAE
reconstructs through its inner CVAE or moves towards a target class
(:class:`ProcessedDataset` and its subclasses).  The models run in eval on
their own device, in chunks of at most 64 clouds (``processed.py:48``), as
batches are fetched.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from pccf_torch.data.structures import Inputs, Targets, WInputs, WTargets

MAX_BATCH = 64

# a chunk's noise: the decoder's initial sampling (n, points, sample_dim) and,
# for a dataset that samples the inner CVAE's posterior, the standard normal
# draws of z1 and z2 (n, T, z1_dim), (n, T, z2_dim)
Noise = tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]


class WDatasetWithLogits:
    """``(WInputs, WTargets)`` batches over a set of clouds
    (``processed.py:128-146``): ``source`` is a cloud tensor ``(N, P, 3)`` or
    a dataset of ``(Inputs, Targets)`` batches, whose inference switch and
    numpy generator this dataset passes through.  The two models are frozen:
    this dataset puts them in eval mode and computes without gradients."""

    supports_workers = False  # its batches are derived on the device

    def __init__(self, source, vqvae: torch.nn.Module, classifier: torch.nn.Module) -> None:
        self.source = source
        self.vqvae, self.classifier = vqvae.eval(), classifier.eval()

    def __len__(self) -> int:
        return len(self.source)

    def set_inference(self, inference: bool) -> None:
        if hasattr(self.source, 'set_inference'):
            self.source.set_inference(inference)

    @property
    def rng(self):
        return self.source.rng  # AttributeError for a tensor: the loader then seeds nothing

    @rng.setter
    def rng(self, value) -> None:
        self.source.rng = value

    def _inputs(self, idx_list: Sequence[int]) -> Inputs:
        if isinstance(self.source, torch.Tensor):
            return Inputs(cloud=self.source[torch.as_tensor(idx_list, dtype=torch.long, device=self.source.device)])
        return self.source.__getitems__(idx_list)[0]

    @torch.no_grad()
    def __getitems__(self, idx_list: Sequence[int]) -> tuple[WInputs, WTargets]:
        device = self.vqvae.codebook.device
        batch = self._inputs(idx_list)
        parts = []
        for start in range(0, len(idx_list), MAX_BATCH):
            rows = slice(start, start + MAX_BATCH)
            inputs = Inputs(cloud=batch.cloud[rows].to(device),
                            indices=None if batch.indices is None else batch.indices[rows].to(device))
            data = self.vqvae.encode_quantize(inputs)
            parts.append((data.w_q, data.w_e, data.one_hot_idx, self.classifier(inputs)))
        w_q, w_e, one_hot, logits = (torch.cat(p) for p in zip(*parts))
        return WInputs(w_q, logits), WTargets(w_e=w_e, one_hot_idx=one_hot, logits=logits)


class ProcessedDataset:
    """Clouds the frozen VQ-VAE makes from a labelled backing dataset
    (``processed.py:45-94``), fetched as ``(Inputs(cloud), Targets(ref_cloud=
    cloud, label))``.

    The backing dataset (``__len__``, ``__getitems__`` giving ``(Inputs,
    Targets)`` with labels, ``seed``) is cut into consecutive chunks of
    :data:`MAX_BATCH` clouds; a fetch computes the chunks its indices fall in
    and keeps them for the fetches that follow, until a fetch needs another
    chunk or a new pass begins (``set_inference``, which the loader calls
    before every pass).  Every chunk computed draws fresh noise (the
    decoder's initial sampling and, where the dataset samples the inner
    CVAE's posterior, its Gaussian noise) from a host ``torch.Generator``
    seeded from the backing dataset's ``seed``, as JAX folds a fresh key per
    fetch from it (``processed.py:57-67``), and copies it to the models'
    device: the same seed gives the same noise on the card and on the CPU.
    ``noise(n)``, when given, hands each chunk of ``n`` clouds its noise
    instead."""

    stochastic = False  # whether the inner CVAE's posterior is sampled

    supports_workers = False  # its batches are derived on the device

    def __init__(self, dataset, autoencoder: torch.nn.Module, noise: Callable[[int], Noise] | None = None) -> None:
        self.dataset, self.autoencoder, self.noise = dataset, autoencoder.eval(), noise
        self.device = autoencoder.codebook.device
        self.generator = torch.Generator().manual_seed(int(getattr(dataset, 'seed', 0)))
        self._chunks: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self.dataset)

    def set_inference(self, inference: bool) -> None:
        self._chunks = {}
        if hasattr(self.dataset, 'set_inference'):
            self.dataset.set_inference(inference)

    def draw(self, n: int) -> Noise:
        """The noise of a chunk of ``n`` clouds."""
        if self.noise is not None:
            return self.noise(n)
        ae, wae = self.autoencoder, self.autoencoder.w_autoencoder
        shapes = [(n, ae.n_inference_output_points, ae.decoder.sample_dim)]
        if self.stochastic:
            shapes += [(n, wae.n_codes, wae.z1_dim), (n, wae.n_codes, wae.z2_dim)]
        sampling, *eps = (torch.randn(shape, generator=self.generator).to(self.device) for shape in shapes)
        return sampling, tuple(eps) if eps else None

    @torch.no_grad()
    def __getitems__(self, idx_list: Sequence[int]) -> tuple[Inputs, Targets]:
        needed = sorted({int(i) // MAX_BATCH for i in idx_list})
        chunks = {c: self._chunks[c] if c in self._chunks else self._chunk(c) for c in needed}
        self._chunks = chunks
        starts, offset = {}, 0
        for c in needed:
            starts[c] = offset
            offset += chunks[c][0].shape[0]
        rows = torch.as_tensor([starts[int(i) // MAX_BATCH] + int(i) % MAX_BATCH for i in idx_list],
                               device=self.device)
        cloud = torch.cat([chunks[c][0] for c in needed])[rows]
        label = torch.cat([chunks[c][1] for c in needed])[rows]
        return Inputs(cloud), Targets(ref_cloud=cloud, label=label)

    def _chunk(self, c: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Chunk ``c``'s clouds and labels."""
        inputs, targets = self.dataset.__getitems__(list(range(c * MAX_BATCH, min((c + 1) * MAX_BATCH, len(self)))))
        cloud = inputs.cloud.to(self.device)
        sampling, eps = self.draw(cloud.shape[0])
        return self.derive(Inputs(cloud, initial_sampling=sampling), eps), targets.label.to(self.device)

    def derive(self, inputs: Inputs, eps) -> torch.Tensor:
        """The clouds ``(n, points, 3)`` derived from ``inputs``."""
        raise NotImplementedError


class _ClassifierMixin:
    classifier: torch.nn.Module

    def _logits(self, inputs: Inputs) -> torch.Tensor:
        return self.classifier(Inputs(inputs.cloud))


class DoubleReconstructedDatasetEncoder(ProcessedDataset):
    """Reconstructions through the inner CVAE's sampled roundtrip with
    uniform class probabilities (``processed.py:160-178``); the VQ-VAE must
    be the unconditional one."""

    stochastic = True

    def derive(self, inputs: Inputs, eps) -> torch.Tensor:
        return self.autoencoder.double_reconstruct(inputs, eps).recon


class DoubleReconstructedDatasetWithLogits(ProcessedDataset, _ClassifierMixin):
    """Reconstructions through the inner CVAE's sampled roundtrip conditioned
    on the classifier's logits of the clouds (``processed.py:181-204``)."""

    stochastic = True

    def __init__(self, dataset, autoencoder: torch.nn.Module, classifier: torch.nn.Module,
                 noise: Callable[[int], Noise] | None = None) -> None:
        super().__init__(dataset, autoencoder, noise)
        self.classifier = classifier.eval()

    def derive(self, inputs: Inputs, eps) -> torch.Tensor:
        return self.autoencoder.double_reconstruct_with_logits(inputs, self._logits(inputs), eps).recon


class CounterfactualDatasetEncoder(ProcessedDataset, _ClassifierMixin):
    """Counterfactual clouds: the class probabilities moved ``target_value``
    of the way towards ``target_dim``, which is every cloud's label
    (``processed.py:207-247``)."""

    def __init__(self, dataset, autoencoder: torch.nn.Module, classifier: torch.nn.Module, target_dim: int,
                 target_value: float = 1.0, noise: Callable[[int], Noise] | None = None) -> None:
        super().__init__(dataset, autoencoder, noise)
        self.classifier, self.target_dim, self.target_value = classifier.eval(), target_dim, target_value

    def _chunk(self, c: int) -> tuple[torch.Tensor, torch.Tensor]:
        recon, label = super()._chunk(c)
        return recon, torch.full_like(label, self.target_dim)

    def derive(self, inputs: Inputs, eps) -> torch.Tensor:
        return self.autoencoder.generate_counterfactual(inputs, self._logits(inputs), self.target_dim,
                                                        self.target_value).recon


class BoundaryDataset(CounterfactualDatasetEncoder):
    """The counterfactual dataset with ``target_value`` 0: the classifier's
    own probabilities (``processed.py:250-254``)."""

    def __init__(self, dataset, autoencoder: torch.nn.Module, classifier: torch.nn.Module, target_dim: int = 0,
                 noise: Callable[[int], Noise] | None = None) -> None:
        super().__init__(dataset, autoencoder, classifier, target_dim, 0.0, noise)

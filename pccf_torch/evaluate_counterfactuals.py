"""The five counterfactual evaluation suites (``evaluate_counterfactuals.py``).

The trained classifier judges clouds the VQ-VAE makes:

1. ``ClassificationOriginal``: the clouds themselves (outputs stored);
2. ``ClassificationReconstructed``: their double reconstructions, through the
   inner CVAE's sampled roundtrip conditioned on the classifier's logits;
3. ``Counterfeit_to_j`` for every class ``j``: counterfactuals towards ``j``,
   labelled ``j``, so the accuracy is the counterfeit success; their states
   merged give the overall counterfeit success;
4. ``MisclassifiedReconstructed``: the double reconstructions of the clouds
   the classifier gets wrong;
5. ``i_to_j``: the clouds predicted ``i`` whose label is ``j``, moved towards
   ``j``, merged over ``(i, j)``.

Every suite is a :class:`~pccf_torch.train.Test` of the classifier in
batches of ``classifier.train.batch_size`` (16) under the classification
objective; the derived datasets run the VQ-VAE in chunks of 64
(:mod:`pccf_torch.data.processed`).  The entry point loads both
checkpoints of the current experiment
(:func:`~pccf_torch.train.w_autoencoder.load_models`) and runs the suites
over the val split (test where ``final``), printing what the JAX script
prints; :func:`evaluate_counterfactuals` takes cloud tensors and labels, and
:func:`run_suites` is the core both run.

    python -m pccf_torch.evaluate_counterfactuals data/dataset=synthetic user.cpu=true
    metrics = evaluate_counterfactuals(cfg, classifier, vqvae, clouds, labels)
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig
from pccf_torch.data.clouds import LabelledClouds
from pccf_torch.data.dataset import get_dataset
from pccf_torch.data.protocols import Partitions
from pccf_torch.data.processed import CounterfactualDatasetEncoder, DoubleReconstructedDatasetWithLogits
from pccf_torch.nn.classifier import ClassifierTrainModule, DGCNNClassifier
from pccf_torch.train.losses import get_classification_loss
from pccf_torch.train.objectives import Objective, compute_metrics
from pccf_torch.train.runners import Loader, Test

Suites = dict[str, dict[str, float]]


class Subset:
    """The items ``indices`` of ``dataset``, which keeps its ``seed`` so that
    datasets derived from the subset draw seed-dependent noise
    (``evaluate_counterfactuals.py:20-42``)."""

    def __init__(self, dataset, indices) -> None:
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitems__(self, idx_list):
        return self.dataset.__getitems__([self.indices[int(i)] for i in idx_list])

    def set_inference(self, inference: bool) -> None:
        if hasattr(self.dataset, 'set_inference'):
            self.dataset.set_inference(inference)

    @property
    def seed(self) -> int:
        return int(getattr(self.dataset, 'seed', 0))


def get_label_distribution(dataset, num_classes: int) -> np.ndarray:
    """The labels on the host, their counts printed (``:45-50``)."""
    labels = torch.as_tensor(dataset.labels).cpu().numpy()
    distribution = {f'count_{i}': int((labels == i).sum()) for i in range(num_classes)}
    print('label distribution:', distribution)
    return labels


def _test(classifier: DGCNNClassifier, dataset, batch_size: int, name: str, suites: Suites,
          store_outputs: bool = False) -> Test:
    """A classification test of ``classifier`` over ``dataset``, run,
    printed and recorded in ``suites``."""
    test = Test(ClassifierTrainModule(classifier), Loader(dataset, batch_size), get_classification_loss(), name,
                model_name=getattr(classifier, 'name', None))
    test(store_outputs=store_outputs)
    print_suite(name, test)
    suites[name] = compute_metrics(test.objective)
    return test


def _merged(tests: list[Test], title: str, name: str, suites: Suites) -> None:
    """The tests' running states merged (``:78-85``, ``:117-124``), printed and recorded."""
    if not tests:
        return
    merged: Objective = tests[0].objective.copy()
    for test in tests[1:]:
        merged.merge_state(test.objective)
    print(title)
    suites[name] = compute_metrics(merged)
    for key, value in suites[name].items():
        print(f'{key}: {round(value, 3)}')


def evaluate_original(classifier, dataset, batch_size: int, suites: Suites) -> Test:
    return _test(classifier, dataset, batch_size, 'ClassificationOriginal', suites, store_outputs=True)


def evaluate_reconstructed(classifier, dataset, vqvae, batch_size: int, suites: Suites) -> None:
    _test(classifier, DoubleReconstructedDatasetWithLogits(dataset, vqvae, classifier), batch_size,
          'ClassificationReconstructed', suites)


def evaluate_counterfactual_performance(classifier, dataset, vqvae, n_classes: int, batch_size: int,
                                        target_value: float, suites: Suites) -> None:
    tests = [_test(classifier, CounterfactualDatasetEncoder(dataset, vqvae, classifier, j, target_value), batch_size,
                   f'Counterfeit_to_{j}', suites) for j in range(n_classes)]
    _merged(tests, 'Overall counterfeit success:', 'OverallCounterfeit', suites)


def evaluate_misclassified(classifier, dataset, vqvae, labels: np.ndarray, predictions: np.ndarray,
                           batch_size: int, suites: Suites) -> None:
    mis = np.nonzero(predictions != labels)[0]
    if len(mis) == 0:
        print('MisclassifiedReconstructed: no misclassified samples')
        return
    _test(classifier, DoubleReconstructedDatasetWithLogits(Subset(dataset, mis), vqvae, classifier), batch_size,
          'MisclassifiedReconstructed', suites)


def evaluate_class_transitions(classifier, dataset, vqvae, labels: np.ndarray, predictions: np.ndarray,
                               n_classes: int, batch_size: int, target_value: float, suites: Suites) -> None:
    tests = []
    for i in range(n_classes):
        for j in range(n_classes):
            mask = (predictions == i) & (labels == j)
            if i == j or not mask.any():
                continue
            derived = CounterfactualDatasetEncoder(Subset(dataset, np.nonzero(mask)[0]), vqvae, classifier, j,
                                                   target_value)
            tests.append(_test(classifier, derived, batch_size, f'{i}_to_{j}', suites))
    _merged(tests, 'Overall misclassified counterfeit success:', 'OverallMisclassifiedCounterfeit', suites)


def print_suite(name: str, test: Test) -> None:
    metrics = compute_metrics(test.objective)
    print(f'[{name}] ' + ', '.join(f'{k}: {round(v, 4)}' for k, v in metrics.items()))


def evaluate_counterfactuals(cfg: SliceConfig, classifier: DGCNNClassifier, vqvae: torch.nn.Module,
                             clouds: torch.Tensor, labels: torch.Tensor, *, seed: int = 0,
                             device: torch.device | str = 'cuda') -> Suites:
    """Run the five suites over ``clouds (N, P, 3)`` and ``labels (N,)``
    (``evaluate_counterfactuals.py:132-151``).  The models and clouds move to
    ``device``, the card unless the caller asks for the CPU; the derived
    datasets seed their noise from ``seed``.  Returns each suite's metrics by
    its name, the merged ones under ``'OverallCounterfeit'`` and
    ``'OverallMisclassifiedCounterfeit'``; ``'ClassificationOriginal'`` holds
    what the JAX entry point returns."""
    device = torch.device(device)
    classifier, vqvae = classifier.to(device).eval(), vqvae.to(device).eval()
    return run_suites(cfg, classifier, vqvae, LabelledClouds(clouds.to(device), labels.to(device), seed))


def run_suites(cfg: SliceConfig, classifier: DGCNNClassifier, vqvae: torch.nn.Module, dataset) -> Suites:
    """The five suites over ``dataset`` (labelled ``(Inputs, Targets)``
    batches in inference, a ``labels`` array, a ``seed``), the models on
    the dataset's device."""
    num_classes, batch_size = cfg.data.n_classes, cfg.classifier.train.batch_size
    target_value = cfg.user.counterfactual_value
    dataset.set_inference(True)
    suites: Suites = {}
    host_labels = get_label_distribution(dataset, num_classes)
    original = evaluate_original(classifier, dataset, batch_size, suites)
    evaluate_reconstructed(classifier, dataset, vqvae, batch_size, suites)
    evaluate_counterfactual_performance(classifier, dataset, vqvae, num_classes, batch_size, target_value, suites)
    predictions = torch.cat(original.outputs_list).numpy().argmax(axis=1)
    evaluate_misclassified(classifier, dataset, vqvae, host_labels, predictions, batch_size, suites)
    evaluate_class_transitions(classifier, dataset, vqvae, host_labels, predictions, num_classes, batch_size,
                               target_value, suites)
    return suites


def stage(cfg: SliceConfig, device: torch.device) -> Suites:
    """``evaluate_counterfactuals.py``'s run inside the current experiment."""
    from pccf_torch.train.w_autoencoder import load_models

    classifier, vqvae = load_models(cfg, device)
    dataset = get_dataset(cfg, Partitions.test if cfg.final else Partitions.val, device)
    return run_suites(cfg, classifier, vqvae, dataset)


def main(argv: list[str] | None = None) -> Suites:
    return cli.run(argv, stage)


if __name__ == '__main__':
    main()

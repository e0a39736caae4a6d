"""Classifier training: the DGCNN point-cloud classifier
(``train_classifier.py:33-113``).

SGD under the cosine schedule, with the classification objective (cross
entropy, with the accuracy and the macro accuracy reported); the training
clouds are augmented on the host, batch by batch
(:class:`~pccf_torch.data.clouds.LabelledClouds`), and the classifier drops
out in its head with masks from the trainer's generator.  A validation pass
over the test clouds follows every epoch, then the final test keeps its
logits, from which come the predictions, the confusion matrix and the
misclassified indices, printed as the JAX entry point prints them without
its trackers.  Not ported: early stopping, which the flagship composition
turns on for the classifier (``classifier/train/early_stopping``: window 5,
patience 10, unless ``final``), so this entry point always trains
``n_epochs``; trackers, the confusion-matrix figure, checkpoints and
data-parallel training.  It takes cloud tensors and labels.

    result = train_classifier(cfg, classifier, train_clouds, train_labels, test_clouds, test_labels)
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch.config import SliceConfig
from pccf_torch.data.clouds import LabelledClouds
from pccf_torch.nn.classifier import ClassifierTrainModule, DGCNNClassifier
from pccf_torch.train.losses import get_classification_loss
from pccf_torch.train.runners import Loader, Test, Trainer

MAX_LOG = 100  # misclassified indices printed at most (train_classifier.py:81)


def confusion_matrix(predictions: np.ndarray, labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Row = true class, column = prediction (``pccf/utils/visualization.py:335-339``)."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (labels, predictions), 1)
    return cm


def train_classifier(
    cfg: SliceConfig,
    classifier: DGCNNClassifier,
    train_clouds: torch.Tensor,
    train_labels: torch.Tensor,
    test_clouds: torch.Tensor,
    test_labels: torch.Tensor,
    *,
    n_epochs: int | None = None,
    seed: int = 0,
    device: torch.device | str = 'cuda',
) -> dict:
    """Train ``classifier`` on ``train_clouds (N, P, 3)`` with
    ``train_labels (N,)``, validating on the test clouds after every epoch,
    then test with stored outputs.  The model moves to ``device``, the card
    unless the caller asks for the CPU.  ``n_epochs`` defaults to the
    configured 45.  Returns the trainer, the final test's metrics, its
    logits ``(M, C)``, the predictions, the confusion matrix and the
    misclassified indices."""
    device = torch.device(device)
    ccfg = cfg.classifier.train
    model = ClassifierTrainModule(classifier).to(device)
    train_loader = Loader(LabelledClouds(train_clouds.to(device), train_labels, seed, data=cfg.data),
                          ccfg.batch_size, seed)
    test_set = LabelledClouds(test_clouds.to(device), test_labels, seed)
    test_loader = Loader(test_set, ccfg.batch_size, seed)
    loss = get_classification_loss()
    trainer = Trainer(model, loss, ccfg, train_loader.n_batches(), seed=seed)
    trainer.train_until(train_loader, ccfg.n_epochs if n_epochs is None else n_epochs,
                        Test(model, test_loader, loss, 'Validation', seed=seed))
    final_test = Test(model, test_loader, loss, 'FinalTest', seed=seed)
    results = final_test(trainer.epoch, store_outputs=True)

    logits = torch.cat(final_test.outputs_list).numpy()
    predictions = logits.argmax(axis=1)
    labels = test_set.labels.cpu().numpy()
    misclassified = [int(i) for i in np.nonzero(predictions != labels)[0]]
    mis_str = str(misclassified[:MAX_LOG])
    if len(misclassified) > MAX_LOG:
        mis_str += f' ... (and {len(misclassified) - MAX_LOG} more)'
    names = [str(i) for i in range(cfg.data.n_classes)]
    cm = confusion_matrix(predictions, labels, cfg.data.n_classes)
    print(f'Confusion Matrix for classes {names}')
    print(cm)
    print(f'Misclassified indices: {mis_str}')
    return {'trainer': trainer, 'test': results, 'logits': logits, 'predictions': predictions,
            'confusion_matrix': cm, 'misclassified': misclassified}

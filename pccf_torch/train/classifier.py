"""Classifier training: the DGCNN point-cloud classifier
(``train_classifier.py:33-113``).

SGD under the configured schedule, with the classification objective (cross
entropy, with the accuracy and the macro accuracy reported); the classifier
drops out in its head with masks from the trainer's generator.  A
validation pass over the test set follows every epoch unless ``final``,
then the final test keeps its logits, from which come the predictions, the
confusion matrix and the misclassified indices, printed as the JAX entry
point prints them without TensorBoard (the confusion-matrix figure is not
ported).  Early stopping (``classifier/train/early_stopping``: window 5,
patience 10 in the flagship) stops training unless ``final``; checkpoints
are saved every ``user.checkpoint_every`` epochs and at the end, and
``user.load_checkpoint`` resumes from one.

    python -m pccf_torch.train.classifier data/dataset=synthetic user.cpu=true

:func:`train_classifier` takes cloud tensors and labels, augmented on the
host (:class:`~pccf_torch.data.clouds.LabelledClouds`), and trains
``n_epochs`` with no early stopping or checkpoints; :func:`fit` is the core
both run.
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig
from pccf_torch.data.clouds import LabelledClouds
from pccf_torch.data.dataset import get_datasets
from pccf_torch.nn.classifier import ClassifierTrainModule, DGCNNClassifier, build_classifier
from pccf_torch.nn.layers import init_for_training
from pccf_torch.train.hooks import EarlyStoppingCallback, call_every, get_trailing_mean, saving_hook
from pccf_torch.train.losses import get_classification_loss
from pccf_torch.train.runners import Loader, Test, Trainer

MAX_LOG = 100  # misclassified indices printed at most (train_classifier.py:81)


def confusion_matrix(predictions: np.ndarray, labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Row = true class, column = prediction (``pccf/utils/visualization.py:335-339``)."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (labels, predictions), 1)
    return cm


def fit(cfg: SliceConfig, classifier: DGCNNClassifier, train_set, test_set, test_labels: np.ndarray, *,
        n_epochs: int, seed: int, device: torch.device, validate: bool = True, early_stopping: bool = False,
        checkpoint_every: int = 0, load_checkpoint: int = 0, save: bool = False,
        class_names: list[str] | None = None, n_workers: int = 0) -> dict:
    """Train on ``train_set``, validating on ``test_set`` after every epoch
    where ``validate``, then test with stored outputs and print what
    ``train_classifier.py:73-103`` prints (the classes by ``class_names``,
    by default their indices).  ``n_workers`` loader worker processes
    assemble the training batches where the dataset allows it."""
    ccfg = cfg.classifier.train
    model = ClassifierTrainModule(classifier).to(device)
    train_loader = Loader(train_set, ccfg.batch_size, seed, n_workers)
    test_loader = Loader(test_set, ccfg.batch_size, seed)
    loss = get_classification_loss()
    name = cfg.classifier.name
    trainer = Trainer(model, loss, ccfg, train_loader.n_batches(), seed=seed, name=name)
    final_test = Test(model, test_loader, loss, 'FinalTest', seed=seed, model_name=name)
    if load_checkpoint:
        trainer.load_checkpoint(load_checkpoint)
    if early_stopping:
        es = ccfg.early_stopping
        trainer.post_epoch_hooks.append(
            EarlyStoppingCallback(loss, filter_fn=get_trailing_mean(es.window), patience=es.patience))
    if checkpoint_every:
        trainer.post_epoch_hooks.append(call_every(checkpoint_every)(saving_hook))
    validation = Test(model, test_loader, loss, 'Validation', seed=seed, model_name=name) if validate else None
    try:
        trainer.train_until(train_loader, n_epochs, validation)
    finally:
        train_loader.close()
    if save:
        trainer.save_checkpoint()
    results = final_test(trainer.epoch, store_outputs=True)

    logits = torch.cat(final_test.outputs_list).numpy()
    predictions = logits.argmax(axis=1)
    misclassified = [int(i) for i in np.nonzero(predictions != test_labels)[0]]
    mis_str = str(misclassified[:MAX_LOG])
    if len(misclassified) > MAX_LOG:
        mis_str += f' ... (and {len(misclassified) - MAX_LOG} more)'
    names = class_names or [str(i) for i in range(cfg.data.n_classes)]
    cm = confusion_matrix(predictions, test_labels, cfg.data.n_classes)
    print(f'Confusion Matrix for classes {names}')
    print(cm)
    print(f'Misclassified indices: {mis_str}')
    return {'trainer': trainer, 'test': results, 'logits': logits, 'predictions': predictions,
            'confusion_matrix': cm, 'misclassified': misclassified}


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
    train_set = LabelledClouds(train_clouds.to(device), train_labels, seed, data=cfg.data)
    test_set = LabelledClouds(test_clouds.to(device), test_labels, seed)
    return fit(cfg, classifier, train_set, test_set, test_set.labels.cpu().numpy(),
               n_epochs=cfg.classifier.train.n_epochs if n_epochs is None else n_epochs, seed=seed, device=device)


def build(cfg: SliceConfig, seed: int) -> DGCNNClassifier:
    """The classifier with its initial weights from ``seed``."""
    classifier = build_classifier(cfg)
    init_for_training(classifier, seed)
    return classifier


def stage(cfg: SliceConfig, device: torch.device) -> dict:
    """``train_classifier.py``'s run inside the current experiment."""
    seed = cfg.user.seed or 0
    train_set, test_set = get_datasets(cfg, device)
    test_set.set_inference(True)
    return fit(cfg, build(cfg, seed), train_set, test_set, test_set.labels, n_epochs=cfg.classifier.train.n_epochs,
               seed=seed, device=device, validate=not cfg.final,
               early_stopping=not cfg.final and cfg.classifier.train.early_stopping.active,
               checkpoint_every=cfg.user.checkpoint_every, load_checkpoint=cfg.user.load_checkpoint, save=True,
               class_names=list(cfg.data.setting('select_classes', [str(i) for i in range(cfg.data.n_classes)])),
               n_workers=cfg.user.n_workers)


def main(argv: list[str] | None = None) -> dict:
    return cli.run(argv, stage)


if __name__ == '__main__':
    main()

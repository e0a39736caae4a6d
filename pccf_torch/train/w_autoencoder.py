"""Stage-2 training: the inner conditional W-autoencoder
(``train_w_autoencoder.py:39-170``).

The latent-code dataset is derived on the card from the frozen VQ-VAE and
classifier (:class:`~pccf_torch.data.processed.WDatasetWithLogits`); only the
inner CVAE trains, inside a :class:`~pccf_torch.models.WAETrainModule` that
holds the VQ-VAE's codebook; after every epoch a validation pass runs the
model in eval (the W-nets' stacks through the ``wformer`` kernels) unless
``final``, early stopping where ``w_autoencoder.train.early_stopping.active``
(off in the flagship), a final test pass follows training, and the trained
weights are merged back into the VQ-VAE.  The entry point loads the latest
classifier and VQ-VAE checkpoints (:func:`load_models`) and saves the merged
VQ-VAE at its epoch.  As in JAX, ``user.load_checkpoint`` is a boolean here:
set, the inner CVAE starts from the VQ-VAE's own instead of fresh weights,
and -1 skips training (test and merge only).  Data-parallel training is not
ported.

    python -m pccf_torch.train.w_autoencoder data/dataset=synthetic user.cpu=true

:func:`train_w_autoencoder` takes cloud tensors; :func:`fit` is the core
both run.
"""

from __future__ import annotations

import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig
from pccf_torch.data.dataset import get_datasets
from pccf_torch.data.processed import WDatasetWithLogits
from pccf_torch.models.autoencoders import VQVAE, build_vqvae
from pccf_torch.models.w_autoencoders import WAETrainModule, build_w_autoencoder
from pccf_torch.nn.classifier import ClassifierTrainModule, build_classifier
from pccf_torch.nn.layers import init_for_training, init_from_seed
from pccf_torch.train.checkpoint import Checkpoint
from pccf_torch.train.hooks import EarlyStoppingCallback, get_moving_average, get_trailing_mean
from pccf_torch.train.losses import get_w_autoencoder_loss
from pccf_torch.train.runners import Loader, Test, Trainer


def build_w_train_model(cfg: SliceConfig, vqvae: VQVAE, reset: bool = True, seed: int = 0,
                        init=init_from_seed) -> WAETrainModule:
    """The inner CVAE in its training shell on the VQ-VAE's device, with the
    VQ-VAE's codebook (``train_w_autoencoder.py:39-69``): fresh weights from
    ``seed`` by ``init`` when ``reset``, else the VQ-VAE's own inner CVAE."""
    model = WAETrainModule(build_w_autoencoder(cfg), cfg.autoencoder.book_size)
    if reset:
        init(model.wae, seed)
    else:
        model.wae.load_state_dict(vqvae.w_autoencoder.state_dict())
    model = model.to(vqvae.codebook.device)
    with torch.no_grad():
        model.codebook.copy_(vqvae.codebook)
    return model


@torch.no_grad()
def merge_back(vqvae: VQVAE, w_model: WAETrainModule) -> None:
    """The trained inner weights into the VQ-VAE (``train_w_autoencoder.py:72-88``)."""
    vqvae.w_autoencoder.load_state_dict(w_model.wae.state_dict())


def fit(cfg: SliceConfig, vqvae: VQVAE, w_model: WAETrainModule, train_set, test_set, *, n_epochs: int, seed: int,
        validate: bool = True, early_stopping: bool = False, train: bool = True, trial=None) -> dict:
    """Train ``w_model`` on ``train_set`` of latent codes where ``train``,
    validating on ``test_set`` where ``validate``, test, and merge back.  A
    tuning ``trial``'s callback (the moving average of the loss) runs after
    early stopping (``train_w_autoencoder.py:124-129``)."""
    wcfg = cfg.w_autoencoder.train
    train_loader = Loader(train_set, wcfg.batch_size, seed)
    test_loader = Loader(test_set, wcfg.batch_size, seed)
    loss = get_w_autoencoder_loss(wcfg, cfg.w_autoencoder.n_pseudo_inputs)
    name = cfg.w_autoencoder.name
    trainer = Trainer(w_model, loss, wcfg, train_loader.n_batches(), seed=seed, name=name)
    if early_stopping:
        es = wcfg.early_stopping
        trainer.post_epoch_hooks.append(
            EarlyStoppingCallback(loss, filter_fn=get_trailing_mean(es.window), patience=es.patience))
    if trial is not None:
        from pccf_torch.tuning import TrialCallback

        trainer.post_epoch_hooks.append(TrialCallback(trial, loss, filter_fn=get_moving_average()))
    if train:
        validation = Test(w_model, test_loader, loss, 'Validation', seed=seed, model_name=name) if validate else None
        trainer.train_until(train_loader, n_epochs, validation)
    results = Test(w_model, test_loader, loss, 'TestEncoding', seed=seed, model_name=name)(trainer.epoch)
    merge_back(vqvae, w_model)
    return {'trainer': trainer, 'test': results, 'loss': results[loss.name]}


def train_w_autoencoder(
    cfg: SliceConfig,
    vqvae: VQVAE,
    classifier: torch.nn.Module,
    train_clouds: torch.Tensor,
    test_clouds: torch.Tensor,
    *,
    n_epochs: int | None = None,
    seed: int = 0,
    device: torch.device | str = 'cuda',
) -> dict:
    """Train the inner CVAE of ``vqvae`` on the codes of ``train_clouds``
    ``(N, P, 3)``, validating on ``test_clouds`` after every epoch, test,
    and merge back (``train_w_autoencoder.py:91-139``).  The models move to
    ``device``, the card unless the caller asks for the CPU.  ``n_epochs``
    defaults to the configured 500; the fresh inner CVAE draws its weights
    from ``seed``.  Returns the trainer, the final test metrics and its
    loss."""
    device = torch.device(device)
    vqvae, classifier = vqvae.to(device), classifier.to(device)
    w_model = build_w_train_model(cfg, vqvae, seed=seed)
    train_set = WDatasetWithLogits(train_clouds.to(device), vqvae, classifier)
    test_set = WDatasetWithLogits(test_clouds.to(device), vqvae, classifier)
    return fit(cfg, vqvae, w_model, train_set, test_set,
               n_epochs=cfg.w_autoencoder.train.n_epochs if n_epochs is None else n_epochs, seed=seed)


def load_models(cfg: SliceConfig, device: torch.device) -> tuple[torch.nn.Module, VQVAE]:
    """The classifier and the VQ-VAE from their latest checkpoints in the
    current experiment (``train_w_autoencoder.py:142-156``), in eval on
    ``device``; the VQ-VAE keeps the loaded epoch as ``epoch``."""
    shell = ClassifierTrainModule(build_classifier(cfg)).to(device)
    Checkpoint(cfg.classifier.name).load(shell, -1)
    vqvae = build_vqvae(cfg).to(device)
    vqvae.epoch = Checkpoint(cfg.autoencoder.name).load(vqvae, -1)
    shell.classifier.name = cfg.classifier.name  # the name its evaluation passes report under
    return shell.classifier.eval(), vqvae.eval()


def train_stage(cfg: SliceConfig, classifier: torch.nn.Module, vqvae: VQVAE, device: torch.device,
                trial=None) -> dict:
    """``train_w_autoencoder.py`` ``train_w_autoencoder``: the inner CVAE of
    ``vqvae`` trained on the codes of the configured dataset, tested and
    merged back; a tuning ``trial`` reports to it and may prune it."""
    seed = cfg.user.seed or 0
    w_model = build_w_train_model(cfg, vqvae, reset=not cfg.user.load_checkpoint, seed=seed, init=init_for_training)
    train_set, test_set = get_datasets(cfg, device)
    es = cfg.w_autoencoder.train.early_stopping
    out = fit(cfg, vqvae, w_model, WDatasetWithLogits(train_set, vqvae, classifier),
              WDatasetWithLogits(test_set, vqvae, classifier), n_epochs=cfg.w_autoencoder.train.n_epochs, seed=seed,
              validate=not cfg.final, early_stopping=not cfg.final and es.active,
              train=cfg.user.load_checkpoint >= 0, trial=trial)
    return {**out, 'vqvae': vqvae, 'classifier': classifier}


def stage(cfg: SliceConfig, device: torch.device) -> dict:
    """``train_w_autoencoder.py``'s run inside the current experiment: load
    both models, train, merge back and save the VQ-VAE."""
    classifier, vqvae = load_models(cfg, device)
    out = train_stage(cfg, classifier, vqvae, device)
    Checkpoint(cfg.autoencoder.name).save(vqvae, vqvae.epoch)
    return out


def main(argv: list[str] | None = None) -> dict:
    return cli.run(argv, stage)


if __name__ == '__main__':
    main()

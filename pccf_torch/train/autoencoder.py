"""Stage-1 training: the VQ-VAE point-cloud autoencoder
(``train_autoencoder.py:41-122``).

The reconstruction objective is the one ``autoencoder.train.recon_loss``
names (ChamferEMD, Chamfer or ChamferSinkhorn) plus the embedding term.  The
inner CVAE stays frozen.  After every epoch a validation pass runs the model
in eval over the test set (unless ``final``), then, every ``diagnose_every``
epochs, the codebook hook (:class:`~pccf_torch.train.hooks.
DiscreteSpaceOptimizer`), early stopping on the reconstruction objective
where ``autoencoder.train.early_stopping.active`` (off in the flagship) and
the checkpoint every ``user.checkpoint_every`` epochs.  A checkpoint is saved
at the end and a final test follows, with ApproxMatch EMD attached as a
metric when the objective has no ``'EMD'`` term.  ``user.load_checkpoint``
resumes from a checkpoint (-1 the latest).  ``user.n_subprocesses=N`` trains
on N data-parallel ranks (:mod:`pccf_torch.dist`).

    python -m pccf_torch.train.autoencoder data/dataset=synthetic user.cpu=true

:func:`train_autoencoder` takes cloud tensors and trains ``n_epochs``
without those harness features; :func:`fit` is the core both run.
"""

from __future__ import annotations

import logging

import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig
from pccf_torch.data.dataset import get_datasets
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.models.autoencoders import VQVAE, build_vqvae
from pccf_torch.nn.layers import init_for_training
from pccf_torch.train.hooks import (DiscreteSpaceOptimizer, EarlyStoppingCallback, TensorBoardLogReconstruction,
                                    call_every, get_moving_average, get_trailing_mean, saving_hook)
from pccf_torch.train.losses import get_autoencoder_loss, get_emd_loss, get_recon_loss
from pccf_torch.train.runners import Diagnostic, Loader, Test, Trainer
from pccf_torch.train.trackers import TrackerNotUsedError

logger = logging.getLogger('pccf_torch')


class _Clouds:
    """``(N, P, 3)`` clouds as stage-1 samples: each cloud is the input and
    the reference of its reconstruction."""

    def __init__(self, clouds: torch.Tensor) -> None:
        self.clouds = clouds

    def __len__(self) -> int:
        return self.clouds.shape[0]

    def __getitems__(self, idx: list[int]) -> tuple[Inputs, Targets]:
        cloud = self.clouds[idx]
        return Inputs(cloud), Targets(ref_cloud=cloud)


class CloudLoader(Loader):
    """Batches of an ``(N, P, 3)`` cloud tensor, in :class:`Loader`'s order."""

    def __init__(self, clouds: torch.Tensor, batch_size: int, seed: int = 0) -> None:
        super().__init__(_Clouds(clouds), batch_size, seed)


def fit(cfg: SliceConfig, vqvae: VQVAE, train_set, test_set, *, n_epochs: int, seed: int, device: torch.device,
        validate: bool = True, early_stopping: bool = False, checkpoint_every: int = 0, load_checkpoint: int = 0,
        save: bool = False, trial=None, n_workers: int = 0) -> dict:
    """Train ``vqvae`` on ``train_set`` with the codebook hook, validating on
    ``test_set`` where ``validate``, then test.  With a tuning ``trial``
    (:class:`pccf_torch.tuning.Trial`) the trial's callback (the moving
    average of the reconstruction objective, reported and pruned on every
    epoch) takes the checkpoint hook's place (``train_autoencoder.py:109-117``).
    ``n_workers`` loader worker processes assemble the training batches
    where the dataset allows it (``train_autoencoder.py:51-53``)."""
    tcfg = cfg.autoencoder.train
    vqvae = vqvae.to(device)
    train_loader = Loader(train_set, tcfg.batch_size, seed, n_workers)
    test_loader = Loader(test_set, tcfg.batch_size, seed)
    loss = get_autoencoder_loss(cfg)
    name = cfg.autoencoder.name
    trainer = Trainer(vqvae, loss, tcfg, train_loader.n_batches(), seed=seed, name=name)
    if load_checkpoint:
        trainer.load_checkpoint(load_checkpoint)
    codebook_hook = DiscreteSpaceOptimizer(Diagnostic(vqvae, train_loader, loss, seed=seed, model_name=name),
                                           cfg.autoencoder.vq_noise, n_epochs, seed)
    trainer.post_epoch_hooks.append(call_every(cfg.autoencoder.diagnose_every)(codebook_hook))
    try:  # train_autoencoder.py:90-97: with a TensorBoard tracker on, every restart interval
        trainer.post_epoch_hooks.append(
            call_every(tcfg.scheduler.restart_interval)(TensorBoardLogReconstruction(train_set)))
    except (TrackerNotUsedError, ImportError) as err:
        logger.info('reconstruction logs skipped: %s', err)
    if early_stopping:
        es = tcfg.early_stopping
        trainer.post_epoch_hooks.append(
            EarlyStoppingCallback(get_recon_loss(cfg), filter_fn=get_trailing_mean(es.window), patience=es.patience))
    if trial is not None:
        from pccf_torch.tuning import TrialCallback

        trainer.post_epoch_hooks.append(TrialCallback(trial, get_recon_loss(cfg), filter_fn=get_moving_average()))
    elif checkpoint_every:
        trainer.post_epoch_hooks.append(call_every(checkpoint_every)(saving_hook))
    validation = Test(vqvae, test_loader, loss, 'Validation', seed=seed, model_name=name) if validate else None
    try:
        trainer.train_until(train_loader, n_epochs, validation)
    finally:
        train_loader.close()
    if save:
        trainer.save_checkpoint()
    test_metric = loss if 'EMD' in loss.calculations else loss | get_emd_loss()
    results = Test(vqvae, test_loader, test_metric, 'FinalTest', seed=seed, model_name=name)(trainer.epoch)
    return {'trainer': trainer, 'test': results, 'loss': results['Chamfer'], 'codebook_hook': codebook_hook}


def train_autoencoder(
    cfg: SliceConfig,
    vqvae: VQVAE,
    train_clouds: torch.Tensor,
    test_clouds: torch.Tensor,
    *,
    n_epochs: int | None = None,
    seed: int = 0,
    device: torch.device | str = 'cuda',
) -> dict:
    """Train ``vqvae`` on ``train_clouds`` ``(N, P, 3)``, validating on
    ``test_clouds`` after every epoch, then test.  The model moves to
    ``device``, the card unless the caller asks for the CPU.  ``n_epochs``
    defaults to the configured 1000; the last epoch trained is the codebook
    hook's final one.  Returns the trainer, the codebook hook (its
    ``last_usage`` holds the latest code counts), the final test metrics and
    their Chamfer distance."""
    device = torch.device(device)
    return fit(cfg, vqvae, _Clouds(train_clouds.to(device)), _Clouds(test_clouds.to(device)),
               n_epochs=cfg.autoencoder.train.n_epochs if n_epochs is None else n_epochs, seed=seed, device=device)


def build(cfg: SliceConfig, seed: int) -> VQVAE:
    """The VQ-VAE with its initial weights from ``seed``."""
    vqvae = build_vqvae(cfg)
    init_for_training(vqvae, seed)
    return vqvae


def stage(cfg: SliceConfig, device: torch.device, trial=None) -> dict:
    """``train_autoencoder.py``'s run inside the current experiment; a
    tuning ``trial`` reports to it and may prune it."""
    seed = cfg.user.seed or 0
    train_set, test_set = get_datasets(cfg, device)
    es = cfg.autoencoder.train.early_stopping
    return fit(cfg, build(cfg, seed), train_set, test_set, n_epochs=cfg.autoencoder.train.n_epochs, seed=seed,
               device=device, validate=not cfg.final, early_stopping=not cfg.final and es.active,
               checkpoint_every=cfg.user.checkpoint_every, load_checkpoint=cfg.user.load_checkpoint, save=True,
               trial=trial, n_workers=cfg.user.n_workers)


def main(argv: list[str] | None = None) -> dict | None:
    """The stage in one process, or, with ``user.n_subprocesses``, on that
    many data-parallel ranks (then None)."""
    return cli.run(argv, stage, data_parallel=True)


if __name__ == '__main__':
    main()

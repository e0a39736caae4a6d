"""Stage-1 training: the VQ-VAE point-cloud autoencoder
(``train_autoencoder.py:41-122``).

The reconstruction objective is the one ``autoencoder.train.recon_loss``
names (ChamferEMD, Chamfer or ChamferSinkhorn) plus the embedding term.  The
inner CVAE stays frozen.  After every epoch a validation pass runs the model
in eval over the test clouds, then, every ``diagnose_every`` epochs, the
codebook hook (:class:`~pccf_torch.train.hooks.DiscreteSpaceOptimizer`).  A
final test follows, with ApproxMatch EMD attached as a metric when the
objective has no ``'EMD'`` term.  Early stopping (off in the flagship),
checkpoints, trackers, the reconstruction-logging hooks, the dataset classes
with their augmentations and data-parallel training are not ported: the
entry point takes cloud tensors.

    result = train_autoencoder(cfg, vqvae, train_clouds, test_clouds)
"""

from __future__ import annotations

import torch

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.models.autoencoders import VQVAE
from pccf_torch.train.hooks import DiscreteSpaceOptimizer, call_every
from pccf_torch.train.losses import get_autoencoder_loss, get_emd_loss
from pccf_torch.train.runners import Diagnostic, Loader, Test, Trainer


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
    tcfg = cfg.autoencoder.train
    n_epochs = tcfg.n_epochs if n_epochs is None else n_epochs
    vqvae = vqvae.to(device)
    train_loader = CloudLoader(train_clouds.to(device), tcfg.batch_size, seed)
    test_loader = CloudLoader(test_clouds.to(device), tcfg.batch_size, seed)
    loss = get_autoencoder_loss(cfg)
    trainer = Trainer(vqvae, loss, tcfg, train_loader.n_batches(), seed=seed)
    codebook_hook = DiscreteSpaceOptimizer(Diagnostic(vqvae, train_loader, loss, seed=seed),
                                           cfg.autoencoder.vq_noise, n_epochs, seed)
    trainer.post_epoch_hooks.append(call_every(cfg.autoencoder.diagnose_every)(codebook_hook))
    trainer.train_until(train_loader, n_epochs, Test(vqvae, test_loader, loss, 'Validation', seed=seed))
    test_metric = loss if 'EMD' in loss.calculations else loss | get_emd_loss()
    results = Test(vqvae, test_loader, test_metric, 'FinalTest', seed=seed)(trainer.epoch)
    return {'trainer': trainer, 'test': results, 'loss': results['Chamfer'], 'codebook_hook': codebook_hook}

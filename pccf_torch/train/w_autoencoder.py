"""Stage-2 training: the inner conditional W-autoencoder
(``train_w_autoencoder.py:39-139``).

The latent-code dataset is derived on the card from the frozen VQ-VAE and
classifier (:class:`~pccf_torch.data.processed.WDatasetWithLogits`); only the
inner CVAE trains, inside a :class:`~pccf_torch.models.WAETrainModule` that
holds the VQ-VAE's codebook; after every epoch a validation pass runs the
model in eval (the W-nets' stacks through the ``wformer`` kernels), a final
test pass follows training, and the trained weights are merged back into the
VQ-VAE.  Early stopping (off in the flagship), trackers, checkpoints and
data-parallel training are not ported.

    loss = train_w_autoencoder(cfg, vqvae, classifier, train_clouds, test_clouds)
"""

from __future__ import annotations

import torch

from pccf_torch.config import SliceConfig
from pccf_torch.data.processed import WDatasetWithLogits
from pccf_torch.models.autoencoders import VQVAE
from pccf_torch.models.w_autoencoders import WAETrainModule, build_w_autoencoder
from pccf_torch.nn.layers import init_from_seed
from pccf_torch.train.losses import get_w_autoencoder_loss
from pccf_torch.train.runners import Loader, Test, Trainer


def build_w_train_model(cfg: SliceConfig, vqvae: VQVAE, reset: bool = True, seed: int = 0) -> WAETrainModule:
    """The inner CVAE in its training shell on the VQ-VAE's device, with the
    VQ-VAE's codebook (``train_w_autoencoder.py:39-69``): fresh weights from
    ``seed`` when ``reset``, else the VQ-VAE's own inner CVAE."""
    model = WAETrainModule(build_w_autoencoder(cfg), cfg.autoencoder.book_size)
    if reset:
        init_from_seed(model.wae, seed)
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
    defaults to the configured 500.  Returns the trainer, the final test
    metrics and its loss."""
    device = torch.device(device)
    wcfg = cfg.w_autoencoder.train
    vqvae, classifier = vqvae.to(device), classifier.to(device)
    w_model = build_w_train_model(cfg, vqvae, seed=seed)
    train_loader = Loader(WDatasetWithLogits(train_clouds.to(device), vqvae, classifier), wcfg.batch_size, seed)
    test_loader = Loader(WDatasetWithLogits(test_clouds.to(device), vqvae, classifier), wcfg.batch_size, seed)
    loss = get_w_autoencoder_loss(wcfg, cfg.w_autoencoder.n_pseudo_inputs)
    trainer = Trainer(w_model, loss, wcfg, train_loader.n_batches(), seed=seed)
    validation = Test(w_model, test_loader, loss, 'Validation', seed=seed)
    trainer.train_until(train_loader, wcfg.n_epochs if n_epochs is None else n_epochs, validation)
    results = Test(w_model, test_loader, loss, 'TestEncoding', seed=seed)(trainer.epoch)
    merge_back(vqvae, w_model)
    return {'trainer': trainer, 'test': results, 'loss': results[loss.name]}

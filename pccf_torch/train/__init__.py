from pccf_torch.train.hooks import DiscreteSpaceOptimizer, call_every
from pccf_torch.train.losses import (get_autoencoder_loss, get_chamfer_emd_losses, get_chamfer_loss,
                                     get_chamfer_sinkhorn_losses, get_embed_loss, get_emd_loss, get_recon_loss,
                                     get_w_autoencoder_loss)
from pccf_torch.train.objectives import Loss, Metric, Objective
from pccf_torch.train.runners import Diagnostic, Loader, Test, Trainer
from pccf_torch.train.schedulers import get_scheduler

__all__ = ['Diagnostic', 'DiscreteSpaceOptimizer', 'Loader', 'Loss', 'Metric', 'Objective', 'Test', 'Trainer',
           'call_every', 'get_autoencoder_loss', 'get_chamfer_emd_losses', 'get_chamfer_loss',
           'get_chamfer_sinkhorn_losses', 'get_embed_loss', 'get_emd_loss', 'get_recon_loss', 'get_scheduler',
           'get_w_autoencoder_loss']

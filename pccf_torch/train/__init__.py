from pccf_torch.train.losses import get_autoencoder_loss, get_chamfer_emd_losses, get_embed_loss, get_w_autoencoder_loss
from pccf_torch.train.objectives import Loss, Metric, Objective
from pccf_torch.train.runners import Test, Trainer
from pccf_torch.train.schedulers import get_scheduler

__all__ = ['Loss', 'Metric', 'Objective', 'Test', 'Trainer', 'get_autoencoder_loss', 'get_chamfer_emd_losses',
           'get_embed_loss', 'get_scheduler', 'get_w_autoencoder_loss']

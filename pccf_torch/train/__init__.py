from pccf_torch.train.losses import get_autoencoder_loss, get_chamfer_emd_losses, get_embed_loss
from pccf_torch.train.objectives import Loss, Objective
from pccf_torch.train.runners import Trainer
from pccf_torch.train.schedulers import get_scheduler

__all__ = ['Loss', 'Objective', 'Trainer', 'get_autoencoder_loss', 'get_chamfer_emd_losses',
           'get_embed_loss', 'get_scheduler']

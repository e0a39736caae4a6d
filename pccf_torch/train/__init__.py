from pccf_torch.train.hooks import DiscreteSpaceOptimizer, call_every
from pccf_torch.train.losses import (get_accuracy, get_autoencoder_loss, get_chamfer_emd_losses, get_chamfer_loss,
                                     get_chamfer_sinkhorn_losses, get_classification_loss, get_cross_entropy_loss,
                                     get_embed_loss, get_emd_loss, get_f1, get_macro_accuracy, get_recon_loss,
                                     get_w_autoencoder_loss)
from pccf_torch.train.objectives import Loss, Metric, Objective, compute_metrics
from pccf_torch.train.runners import Diagnostic, Loader, Test, Trainer
from pccf_torch.train.schedulers import get_scheduler
from pccf_torch.train.tp import TPTrainer, tp_state, tp_train_step

__all__ = ['Diagnostic', 'DiscreteSpaceOptimizer', 'Loader', 'Loss', 'Metric', 'Objective', 'TPTrainer', 'Test',
           'Trainer',
           'call_every', 'compute_metrics', 'get_accuracy', 'get_autoencoder_loss', 'get_chamfer_emd_losses',
           'get_chamfer_loss', 'get_chamfer_sinkhorn_losses', 'get_classification_loss', 'get_cross_entropy_loss',
           'get_embed_loss', 'get_emd_loss', 'get_f1', 'get_macro_accuracy', 'get_recon_loss', 'get_scheduler',
           'get_w_autoencoder_loss', 'tp_state', 'tp_train_step']

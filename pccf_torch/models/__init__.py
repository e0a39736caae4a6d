from pccf_torch.models.autoencoders import VQVAE, Oracle, build_vqvae
from pccf_torch.models.w_autoencoders import WAETrainModule, WAutoEncoder, build_w_autoencoder

__all__ = ['VQVAE', 'Oracle', 'WAETrainModule', 'WAutoEncoder', 'build_vqvae', 'build_w_autoencoder']

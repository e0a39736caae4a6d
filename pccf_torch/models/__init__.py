from pccf_torch.models.autoencoders import VQVAE, build_vqvae
from pccf_torch.models.w_autoencoders import WAutoEncoder, build_w_autoencoder

__all__ = ['VQVAE', 'WAutoEncoder', 'build_vqvae', 'build_w_autoencoder']

from pccf_torch.nn.classifier import DGCNNClassifier, build_classifier
from pccf_torch.nn.decoders import PCGenDecoder, build_decoder
from pccf_torch.nn.encoders import DGCNNEncoder, EdgeConvBlock

__all__ = ['DGCNNClassifier', 'DGCNNEncoder', 'EdgeConvBlock', 'PCGenDecoder', 'build_classifier', 'build_decoder']

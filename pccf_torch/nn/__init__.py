from pccf_torch.nn.classifier import ClassifierTrainModule, DGCNNClassifier, build_classifier
from pccf_torch.nn.decoders import PCGenDecoder, build_decoder
from pccf_torch.nn.encoders import DGCNNEncoder, EdgeConvBlock, LDGCNNEncoder, get_encoder

__all__ = ['ClassifierTrainModule', 'DGCNNClassifier', 'DGCNNEncoder', 'EdgeConvBlock', 'LDGCNNEncoder',
           'PCGenDecoder', 'build_classifier', 'build_decoder', 'get_encoder']

"""DGCNN point-cloud classifier (``pccf/nn/classifier.py``), in eval and in
training, and its training shell."""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Inputs
from pccf_torch.nn.encoders import IN_CHAN, EdgeConvBlock
from pccf_torch.nn.layers import Act, DenseBlock, MLPHead, get_act


class DGCNNClassifier(nn.Module):
    """EdgeConv stack -> global max + mean pooling -> MLP -> logits
    (``classifier.py:33-55``).  In training (``module.train()``) the EdgeConv
    blocks take the streaming-BN path, ``final_conv`` and the head's
    BatchNorm normalise with batch statistics, and the head drops out with
    masks from ``generator``."""

    def __init__(
        self,
        n_classes: int,
        n_neighbors: int,
        conv_dims: tuple[int, ...],
        feature_dim: int,
        mlp_dims: tuple[int, ...],
        act: Act,
        dropout_rates: tuple[float, ...] = (),
    ) -> None:
        super().__init__()
        widths = (IN_CHAN, *conv_dims)
        self.edge_conv = nn.ModuleList(
            EdgeConvBlock(widths[i], widths[i + 1], n_neighbors, act) for i in range(len(conv_dims))
        )
        self.final_conv = DenseBlock(sum(conv_dims), feature_dim, act=None)  # BN, no activation
        self.mlp = MLPHead(2 * feature_dim, mlp_dims, n_classes, act, dropout_rates)

    def forward(self, inputs: Inputs, generator: torch.Generator | None = None) -> torch.Tensor:
        x, idx, xs = inputs.cloud, inputs.indices, []
        for block in self.edge_conv:
            x = block(x, idx)
            idx = None  # dynamic graph after the first block
            xs.append(x)
        x = self.final_conv(torch.cat(xs, dim=-1))
        return self.mlp(torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1), generator)


class ClassifierTrainModule(nn.Module):
    """The classifier under the runners' call ``model(inputs, noise,
    generator)``, as :class:`~pccf_torch.models.WAETrainModule` is the inner
    CVAE's: the logits of ``inputs``, dropout masks from ``generator`` in
    training; the classifier draws no other noise."""

    def __init__(self, classifier: DGCNNClassifier) -> None:
        super().__init__()
        self.classifier = classifier

    def forward(self, inputs: Inputs, noise: None = None, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.classifier(inputs, generator)


def build_classifier(cfg: SliceConfig) -> DGCNNClassifier:
    c = cfg.classifier
    return DGCNNClassifier(
        n_classes=cfg.data.n_classes,
        n_neighbors=c.n_neighbors,
        conv_dims=c.conv_dims,
        feature_dim=c.feature_dim,
        mlp_dims=c.mlp_dims,
        act=get_act(c.act_name),
        dropout_rates=c.dropout_rates,
    )

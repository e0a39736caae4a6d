"""DGCNN point-cloud classifier, eval (``pccf/nn/classifier.py``)."""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.data.structures import Inputs
from pccf_torch.nn.encoders import IN_CHAN, EdgeConvBlock
from pccf_torch.nn.layers import Act, DenseBlock, MLPHead, get_act


class DGCNNClassifier(nn.Module):
    """EdgeConv stack -> global max + mean pooling -> MLP -> logits
    (``classifier.py:33-55``)."""

    def __init__(
        self,
        n_classes: int,
        n_neighbors: int,
        conv_dims: tuple[int, ...],
        feature_dim: int,
        mlp_dims: tuple[int, ...],
        act: Act,
    ) -> None:
        super().__init__()
        widths = (IN_CHAN, *conv_dims)
        self.edge_conv = nn.ModuleList(
            EdgeConvBlock(widths[i], widths[i + 1], n_neighbors, act) for i in range(len(conv_dims))
        )
        self.final_conv = DenseBlock(sum(conv_dims), feature_dim, act=None)  # BN, no activation
        self.mlp = MLPHead(2 * feature_dim, mlp_dims, n_classes, act)

    def forward(self, inputs: Inputs) -> torch.Tensor:
        x, idx, xs = inputs.cloud, inputs.indices, []
        for block in self.edge_conv:
            x = block(x, idx)
            idx = None  # dynamic graph after the first block
            xs.append(x)
        x = self.final_conv(torch.cat(xs, dim=-1))
        return self.mlp(torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1))


def build_classifier(cfg: SliceConfig) -> DGCNNClassifier:
    c = cfg.classifier
    return DGCNNClassifier(
        n_classes=cfg.data.n_classes,
        n_neighbors=c.n_neighbors,
        conv_dims=c.conv_dims,
        feature_dim=c.feature_dim,
        mlp_dims=c.mlp_dims,
        act=get_act(c.act_name),
    )

"""Convert the JAX package's flax variables into the port's ``state_dict``.

Input: the nested dict of numpy arrays a flax model carries (``params``,
``batch_stats`` and ``constants`` collections, e.g.
``jax.tree.map(np.asarray, variables)``).  The stage-2 shell
``WAETrainModule`` converts onto :class:`pccf_torch.models.WAETrainModule`:
``params.wae.*`` onto ``wae.*`` and ``constants.codebook`` onto its
``codebook`` buffer; the merged VQ-VAE (``params.w_autoencoder.*``) onto
``w_autoencoder.*``.
Any tree shaped like ``params`` converts the same way under the ``params``
key, so JAX gradients and updated parameters of a training step land on the
port's parameter names; the training step touches every parameter outside
the frozen ``w_autoencoder`` and every running statistic.  No JAX import is
needed here.  The port's module attributes follow the flax
submodule names, so the mapping is:

- submodule names: ``edge_conv_i``, ``layer_i``, ``map_i``, ``conv_i``,
  ``mlp_i`` and ``points_conv_i`` become list entries (``edge_conv.i``,
  ``layers.i``, ``map.i``, ``conv.i``, ``mlp.i``, ``points_conv.i``): the
  LDGCNN's point convolutions, the convolutional W-encoder's layers and the
  linear W-decoder's grouped layers among them; the LDGCNN's single
  ``edge_conv``, the W-nets' ``head`` and the VampPrior's ``pseudo_inputs``
  keep their names;
  ``DenseBlock_i`` becomes ``blocks.i``; ``LayerNorm_i``,
  ``MultiHeadDotProductAttention_i`` and ``Dense_i`` become ``norm_i``,
  ``attn_i`` and ``dense_i``;
- dense kernels ``(in, out)`` are transposed to ``(out, in)``, and the
  vmapped PCGen stacks ``(G, in, out)`` to ``(G, out, in)``
  (``pccf/nn/decoders.py:95-113``);
- the EdgeConv kernel ``[W_diff; W_self]`` ``(2C, F)`` becomes ``weight``
  ``(F, 2C)``, its ``bn_*`` entries the ``bn`` submodule
  (``pccf/nn/encoders.py:62-66``);
- flax attention kernels ``(E, H, hd)`` / ``(H, hd, E)`` flatten the head
  axes in ``(H, hd)`` order into torch ``Linear`` weights
  (``tests/test_transformer_parity.py:18-51``);
- BatchNorm ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
  ``running_mean``/``running_var``, LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_SEGMENT_RULES = (
    (re.compile(r'^(edge_conv|map|conv|mlp|points_conv)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^layer_(\d+)$'), r'layers.\1'),
    (re.compile(r'^DenseBlock_(\d+)$'), r'blocks.\1'),
    (re.compile(r'^LayerNorm_(\d+)$'), r'norm_\1'),
    (re.compile(r'^MultiHeadDotProductAttention_(\d+)$'), r'attn_\1'),
    (re.compile(r'^Dense_(\d+)$'), r'dense_\1'),
)
_EDGE_BN = {'bn_scale': 'bn.weight', 'bn_bias': 'bn.bias', 'bn_mean': 'bn.running_mean', 'bn_var': 'bn.running_var'}
_BN_STATS = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def _rename(segment: str) -> str:
    for pattern, repl in _SEGMENT_RULES:
        if pattern.match(segment):
            return pattern.sub(repl, segment)
    return segment


def _leaf(path: tuple, leaf: str, a: np.ndarray, collection: str) -> tuple[str, np.ndarray]:
    parent = path[-1] if path else ''
    in_attention = len(path) >= 2 and path[-2].startswith('MultiHeadDotProductAttention_')
    if collection == 'batch_stats':
        if leaf in _EDGE_BN:
            return _EDGE_BN[leaf], a
        return _BN_STATS[leaf], a
    if in_attention and parent in ('query', 'key', 'value'):
        if leaf == 'kernel':  # (E, H, hd) -> (H*hd, E)
            return 'weight', a.reshape(a.shape[0], -1).T
        return 'bias', a.reshape(-1)
    if in_attention and parent == 'out' and leaf == 'kernel':  # (H, hd, E) -> (E, H*hd)
        return 'weight', a.reshape(-1, a.shape[-1]).T
    if leaf in _EDGE_BN:
        return _EDGE_BN[leaf], a
    if leaf == 'kernel':
        return 'weight', np.swapaxes(a, -1, -2)
    if leaf == 'grouped_kernel':  # (G, gin, gout) -> GroupedLinear (G, gout, gin)
        return 'dense.weight', np.swapaxes(a, -1, -2)
    if leaf == 'grouped_bias':
        return 'dense.bias', a
    if leaf == 'scale':
        return 'weight', a
    return leaf, a


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': …, 'batch_stats': …, 'constants': …}`` of a flax model -> the port's
    ``state_dict`` (load it with ``strict=True`` to check coverage)."""
    state = {}
    for collection in ('params', 'batch_stats', 'constants'):
        for path, a in _flatten(variables.get(collection, {})).items():
            name, value = _leaf(path[:-1], path[-1], a, collection)
            key = '.'.join([*(_rename(s) for s in path[:-1]), name])
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32))  # a writable copy
    return state

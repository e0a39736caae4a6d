"""The gates that send eval work to the card's kernels, and the kNN
candidate split, on the CPU.

Each gate is the JAX package's own Pallas predicate without its VMEM budget
(a TPU limit): ``wformer.supported`` / ``_TransformerNet.stack_ok``
``_fused_stack_ok`` with ``wformer_supported``, ``WAutoEncoder.fused_ok``
``_fused_cf_ok`` with ``cvae_cf_supported``, ``PCGenDecoder.fused_ok``
``_fused_eval_ok`` with ``pcgen_fused_supported``.  Here each is held to the
JAX predicate called with its budget lifted.  Inside a gate every shape
launches the card's kernels, heads of any width included; outside it the
module runs its layers one by one, on either device, as JAX runs its XLA
layers; here, on the CPU, the layers agree with the stacked plain version.  ``tests/test_torch_port_wide_gates.py`` sweeps the tuning
spaces' corners.
"""

import numpy as np
import pytest
import torch

from pccf_torch import config as tc
from pccf_torch.kernels import knn, pcgen, wformer
from pccf_torch.nn import w_networks as tw
from pccf_torch.nn.layers import gelu_exact

torch.set_num_threads(1)


@pytest.fixture()
def no_vmem(monkeypatch):
    """The JAX predicates with their VMEM budget lifted."""
    from pccf.kernels import pallas_cvae, pallas_gather, pallas_pcgen, pallas_wformer

    for mod in (pallas_cvae, pallas_gather, pallas_pcgen, pallas_wformer):
        monkeypatch.setattr(mod, '_VMEM_BUDGET', 10 ** 30)


@pytest.mark.parametrize('t,d,heads,ff,ok', [
    (256, 512, 8, (1024, 1024), True),  # the flagship W-nets
    (128, 128, 2, (128, 256, 192), True),
    (256, 256, 8, (1024,), True),  # heads of 32
    (384, 384, 6, (256,), True),  # more than 256 tokens
    (256, 512, 8, (1000,), True),  # an FF width off the GEMM's 64-column tiles
    (256, 512, 8, (96, 1024), True),
    (96, 128, 2, (128,), False),  # the JAX shape line: tokens in multiples of 128
    (256, 128, 16, (137,), True),  # a tuning corner: heads of 8
    (256, 512, 4, (700,), True),  # heads of 128
    (256, 512, 2, (1024,), True),  # heads of 256: inside the gate, refused at launch
    (128, 96, 2, (128,), False),  # width off 128
    (128, 128, 3, (128,), False),  # heads that do not divide the width
])
def test_wformer_gate_states_the_stack_kernels(no_vmem, t, d, heads, ff, ok):
    from pccf.kernels.pallas_wformer import wformer_supported

    assert wformer_supported(t, d, max(ff), len(ff), heads) == ok
    assert wformer.supported(t, d, heads) == ok
    net = tw.TransformerWEncoder(4, 8, t, d, heads, ff, gelu_exact).eval()
    assert net.stack_ok() == ok


def test_failed_stack_gate_runs_layers_on_cpu():
    """96 tokens: the gate fails, and the layers run one by one on the CPU,
    equal to the packed plain stack."""
    net = tw.TransformerWEncoder(4, 8, 96, 256, 8, (256,), gelu_exact).eval()
    assert not net.stack_ok()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 96, 4)).astype(np.float32))
    with torch.no_grad():
        layered = net(x)
        h = net.input_proj(x) + net.positional_encoding
        stacked = net.to_latent(wformer.plain_encoder(h, wformer.pack_encoder(net.layers), net.n_heads))
    torch.testing.assert_close(layered, stacked, rtol=1e-5, atol=1e-5)


def _wae(t, d, heads, ff=(256,), e=4):
    from pccf_torch.models.w_autoencoders import WAutoEncoder

    return WAutoEncoder(
        encoder=tw.TransformerWEncoder(e, 4, t, d, heads, ff, gelu_exact),
        decoder=tw.TransformerWDecoder(e, 4, 4, t, d, heads, ff, gelu_exact),
        z2_prior=tw.ConditionalPrior(2, t, 4),
        z2_posterior=tw.TransformerWConditionalEncoder(e, 2, 4, t, d, heads, ff, gelu_exact),
        n_codes=t, embedding_dim=e, z1_dim=4, z2_dim=4, n_classes=2,
    )


@pytest.mark.parametrize('case,t,d,heads,ff,ok', [
    ('flagship', 256, 512, 8, (1024, 1024), True),
    ('96 tokens', 96, 128, 2, (256,), False),
    ('heads of 32', 256, 256, 8, (256,), True),
    ('FF 160', 128, 128, 2, (160,), True),
    ('heads of 8, FF 137', 256, 128, 16, (137,), True),
    ('heads of 128, FF 700', 128, 512, 4, (700,), True),
    ('width 640, 3 heads', 128, 384, 3, (256,), True),
    ('width off 128', 128, 192, 2, (256,), False),
])
def test_cvae_gate_follows_cvae_cf_supported(no_vmem, case, t, d, heads, ff, ok):
    """The chain's gate against ``pccf.kernels.pallas_cvae.cvae_cf_supported``
    on the same nets, its budget lifted."""
    from pccf.kernels.pallas_cvae import cvae_cf_supported

    wae = _wae(t, d, heads, ff)
    assert cvae_cf_supported(t, d, max(ff), 3 * len(ff), (heads,) * 3, wae.embedding_dim) == ok
    assert wae.fused_ok() == ok


def test_cvae_gate_refuses_embeddings_wider_than_the_chain_pads():
    """JAX pads the token input to one 128-lane tile; the card's chain pads
    to whole GEMM tiles and takes the same embeddings."""
    assert _wae(128, 128, 2, e=32).fused_ok()
    assert _wae(128, 128, 2, e=40).fused_ok()
    assert _wae(128, 128, 2, e=128).fused_ok()
    assert not _wae(128, 128, 2, e=132).fused_ok()


@pytest.mark.parametrize('w_dim,overrides,ok', [
    (1024, {}, True),  # the flagship: 1024-1024-256-16, 8 components, map input 64
    (512, dict(n_components=2, map_dims=(8,), conv_dims=(512, 64, 16)), True),
    (128, dict(n_components=2, map_dims=(8,), conv_dims=(128, 64, 16)), True),
    (1024, dict(conv_dims=(1024, 192, 16)), True),  # the general kernel
    (1024, dict(conv_dims=(1024, 256, 8)), True),
    (1024, dict(conv_dims=(1024, 512, 256, 16)), True),  # four component layers
    (2048, dict(conv_dims=(2048, 256, 16)), True),  # past JAX's VMEM budget only
    (1024, dict(map_dims=(128,)), True),  # a map input wider than 64
    (1024, dict(n_components=16), True),  # more than eight components
    (1024, dict(n_components=1), False),  # the JAX gate's: at least two
    (1024, dict(conv_dims=(300, 500)), False),  # expanding after the first
    (960, dict(conv_dims=(512, 64)), False),  # w_dim off 128
])
def test_pcgen_gate_states_the_kernel_guard(no_vmem, w_dim, overrides, ok):
    """``PCGenDecoder.fused_ok`` and ``pcgen.supported`` against
    ``pcgen_fused_supported`` at 2048 points; at 2000 points (not whole
    256-row tiles) both refuse."""
    from pccf.kernels.pallas_pcgen import pcgen_fused_supported
    from pccf_torch.nn.decoders import build_decoder

    dec = build_decoder(tc.AutoEncoderConfig(w_dim=w_dim, decoder=tc.DecoderConfig(**overrides)))
    assert pcgen_fused_supported(2048, w_dim, dec.conv_dims, dec.n_components) == ok
    assert dec.fused_ok(2048) == ok == dec.fused_ok()
    assert pcgen.supported(2048, w_dim, dec.conv_dims, dec.n_components) == ok
    assert not dec.fused_ok(2000) and not pcgen_fused_supported(2000, w_dim, dec.conv_dims, dec.n_components)


@pytest.mark.parametrize('b,n,want', [(16, 2048, 1), (32, 2048, 1), (8, 2048, 1), (5, 2048, 1), (1, 2048, 4),
                                      (2, 2048, 2), (1, 300, 4), (1, 512, 8), (2, 64, 1)])
def test_knn_splits(b, n, want):
    """One block per cloud tile from batch 5 up (serving's 5 and 16, stage
    1's 8, stage 2's 32); more at batch 1 and 2, the largest power of two the
    kernel takes (at most 16 and at most the cloud's tiles of 64 candidates)
    that keeps the grid within one block an SM."""
    s = knn.splits(b, n)
    assert s == want
    tiles = -(-n // knn.TILE)
    assert s & (s - 1) == 0 and 1 <= s <= min(knn.MAX_SPLITS, tiles)
    assert s == 1 or b * tiles * s <= knn.H100_SMS
    assert b * tiles * 2 * s > knn.H100_SMS or 2 * s > min(knn.MAX_SPLITS, tiles)


def _small_pcgen_pack(g=2, dims=(128, 128, 64, 16), dm=8):
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen) * 0.1

    return pcgen.PCGenPack(map_w=r(dims[0], dm), map_b=r(dims[0]),
                           layer_ws=tuple(r(g, dims[i + 1], dims[i]) for i in range(3)),
                           layer_bs=tuple(r(g, dims[i + 1]) for i in range(3)),
                           head_w=r(g, 3, dims[-1]), head_b=r(g, 3), att_w=r(g, g * dims[-1]), att_b=r(g))


@pytest.mark.parametrize('layer', [0, 1, 2])
@pytest.mark.parametrize('value,ok', [(pcgen.FP16_MAX, True), (-pcgen.FP16_MAX, True), (7e4, False),
                                      (-7e4, False), (float('inf'), False), (float('nan'), False)])
def test_pcgen_pack_refuses_weights_past_fp16(layer, value, ok):
    """The kernel reads the folded component weights in fp16: one past 65504
    (or not finite) would be inf there, so the pack refuses to build them."""
    pack = _small_pcgen_pack()
    pack.layer_ws[layer][1, 2, 3] = value
    if ok:
        ops = pack.cuda_operands()
        assert ops[2 + 2 * layer].dtype == torch.float16
        assert float(ops[2 + 2 * layer][1, 2, 3]) == value
    else:
        with pytest.raises(ValueError, match=f'layer {layer} weights'):
            pack.cuda_operands()

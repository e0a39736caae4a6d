"""The gates that send eval work to the card's kernels, and the kNN
candidate split, on the CPU.

Each gate states what its kernels cover: ``wformer.supported`` the stack
kernels' guards (64-wide heads, at most 256 tokens, FF widths in multiples
of 64, beside the JAX shape line), ``WAutoEncoder.fused_ok`` the CVAE
chain's (``cvae_cf_supported``'s shape test as the card's kernels state it),
``PCGenDecoder.fused_ok`` the guard of ``pccf_pcgen_mix``.  On a CUDA tensor a
net whose gate fails raises the gate's ``NotImplementedError`` before any
launch; here, on the CPU, it runs its layers one by one and agrees with the
stacked plain version.
"""

import numpy as np
import pytest
import torch

from pccf_torch import config as tc
from pccf_torch.kernels import knn, pcgen, wformer
from pccf_torch.nn import w_networks as tw
from pccf_torch.nn.layers import gelu_exact

torch.set_num_threads(1)


@pytest.mark.parametrize('t,d,heads,ff,ok', [
    (256, 512, 8, (1024, 1024), True),  # the flagship W-nets
    (128, 128, 2, (128, 256, 192), True),
    (256, 256, 8, (1024,), False),  # heads of 32
    (384, 384, 6, (256,), False),  # more tokens than the attention kernel's 256 keys
    (256, 512, 8, (1000,), False),  # an FF width off the GEMM's 64-column tiles
    (256, 512, 8, (96, 1024), False),
    (96, 128, 2, (128,), False),  # the JAX shape line: tokens in multiples of 128
])
def test_wformer_gate_states_the_stack_kernels(t, d, heads, ff, ok):
    assert wformer.supported(t, d, heads, ff) == ok
    net = tw.TransformerWEncoder(4, 8, t, d, heads, ff, gelu_exact).eval()
    assert net.stack_ok() == ok


def test_failed_stack_gate_runs_layers_on_cpu():
    """proj 256 with 8 heads (heads of 32): the gate fails, and the layers run
    one by one on the CPU, equal to the packed plain stack."""
    net = tw.TransformerWEncoder(4, 8, 128, 256, 8, (256,), gelu_exact).eval()
    assert not net.stack_ok()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 128, 4)).astype(np.float32))
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


@pytest.mark.parametrize('case,t,d,heads,ff,jax_ok,ok', [
    ('flagship', 256, 512, 8, (1024, 1024), True, True),
    ('96 tokens', 96, 128, 2, (256,), False, False),
    ('heads of 32', 256, 256, 8, (256,), True, False),  # only the card's kernels refuse
    ('FF 160', 128, 128, 2, (160,), True, False),
])
def test_cvae_gate_follows_cvae_cf_supported(case, t, d, heads, ff, jax_ok, ok):
    """The chain's gate against ``pccf.kernels.pallas_cvae.cvae_cf_supported``
    on the same nets: it accepts what the TPU's accepts unless the card's
    kernels do not cover it."""
    from pccf.kernels.pallas_cvae import cvae_cf_supported

    wae = _wae(t, d, heads, ff)
    assert cvae_cf_supported(t, d, max(ff), 3 * len(ff), (heads,) * 3, wae.embedding_dim) == jax_ok
    assert wae.fused_ok() == ok


def test_cvae_gate_refuses_embeddings_wider_than_the_chain_pads():
    assert _wae(128, 128, 2, e=32).fused_ok()
    assert not _wae(128, 128, 2, e=40).fused_ok()


@pytest.mark.parametrize('w_dim,overrides,ok', [
    (1024, {}, True),  # the flagship: 1024-1024-256-16, 8 components, map input 64
    (512, dict(n_components=2, map_dims=(8,), conv_dims=(512, 64, 16)), True),
    (128, dict(n_components=2, map_dims=(8,), conv_dims=(128, 64, 16)), True),
    (1024, dict(conv_dims=(1024, 192, 16)), False),  # layer 1 not a warpgroup-split chunk
    (1024, dict(conv_dims=(1024, 256, 8)), False),  # layer 2 not one n16 product
    (1024, dict(conv_dims=(1024, 512, 256, 16)), False),  # four component layers
    (2048, dict(conv_dims=(2048, 256, 16)), False),  # the join does not fit in shared memory
    (1024, dict(map_dims=(128,)), False),  # a map input wider than 64
    (1024, dict(n_components=16), False),  # more components than a row's four lanes keep
    (1024, dict(n_components=1), False),  # the JAX gate's: at least two
])
def test_pcgen_gate_states_the_kernel_guard(w_dim, overrides, ok):
    from pccf_torch.nn.decoders import build_decoder

    dec = build_decoder(tc.AutoEncoderConfig(w_dim=w_dim, decoder=tc.DecoderConfig(**overrides)))
    assert dec.fused_ok() == ok
    dims = (w_dim, *dec.conv_dims)
    assert pcgen.supported(dec.map_out.dense.in_features, dims, dec.n_components) == ok


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

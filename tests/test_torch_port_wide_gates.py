"""The port's eval gates against the JAX package's Pallas predicates over
every point class of the tuning spaces, on the CPU, and what the card's
wrappers do inside them.

``configs/tuning/w_autoencoder/tune/*.yaml`` draw W-nets of proj_dim 128,
256 or 512 over 4, 8 or 16 heads with FF widths of any integer in 128-1024;
``configs/tuning/autoencoder/tune/decoder.yaml`` PCGen decoders of 1-4
component widths in 64-512 (in any order), map widths 8-256 and sample
dims 8-32; ``encoder.yaml`` LDGCNN widths in 16-512, which the graph pools
take.  Each port gate must equal the JAX predicate it restates, with the
predicate's VMEM budget (a TPU limit) lifted; inside the gate the card
covers every class (heads of any width, PCGen layers of any number, any
pool width), and the padding the wrappers add is exact on the plain
versions.
"""

import itertools

import numpy as np
import pytest
import torch

from pccf_torch import config as tc
from pccf_torch.kernels import cvae, gather, ops, pcgen, wformer
from pccf_torch.nn import w_networks as tw
from pccf_torch.nn.layers import default_act, gelu_exact, init_from_seed

torch.set_num_threads(1)

PROJ = (128, 256, 512)
HEADS = (4, 8, 16)
FF = ((128,), (137,), (1000,), (1024,), (128, 1024, 300), (700, 131))
TOKENS = (256, 128, 96, 384)


@pytest.fixture()
def no_vmem(monkeypatch):
    from pccf.kernels import pallas_cvae, pallas_gather, pallas_pcgen, pallas_wformer

    for mod in (pallas_cvae, pallas_gather, pallas_pcgen, pallas_wformer):
        monkeypatch.setattr(mod, '_VMEM_BUDGET', 10 ** 30)


class _Net:
    """The attributes ``_TransformerNet.stack_ok`` reads, without weights."""

    training = False

    def __init__(self, t, d, heads, ff, act):
        self.n_codes, self.proj_dim, self.n_heads, self.mlp_dims, self.act = t, d, heads, ff, act


@pytest.mark.parametrize('t', TOKENS)
@pytest.mark.parametrize('d', PROJ)
@pytest.mark.parametrize('heads', HEADS)
def test_stack_gate_equals_fused_stack_ok(no_vmem, t, d, heads):
    """``stack_ok`` against ``_fused_stack_ok``'s terms (exact GELU,
    ``wformer_supported``) for every FF class and both activations."""
    from pccf.kernels.pallas_wformer import wformer_supported

    for ff, act in itertools.product(FF, (gelu_exact, default_act)):
        want = act is gelu_exact and wformer_supported(t, d, max(ff), len(ff), heads)
        assert tw._TransformerNet.stack_ok(_Net(t, d, heads, ff, act)) == want, (t, d, heads, ff)


@pytest.mark.parametrize('procs', [(128, 128, 128), (256, 256, 256), (512, 512, 512), (128, 256, 512)])
@pytest.mark.parametrize('e', [4, 128, 132])
def test_chain_gate_equals_fused_cf_ok(no_vmem, procs, e):
    """``WAutoEncoder.fused_ok`` against ``_fused_cf_ok``'s terms: transformer
    nets, exact GELU, one shared width, ``cvae_cf_supported``, over the heads
    of the tuning spaces and embeddings at and past 128."""
    from pccf.kernels.pallas_cvae import cvae_cf_supported
    from pccf_torch.models.w_autoencoders import WAutoEncoder

    for heads in itertools.product(HEADS, repeat=3):
        nets = [_Net(128, d, h, (128,), gelu_exact) for d, h in zip(procs, heads)]
        enc, post, dec = (type(cls.__name__, (cls,), {})
                          for cls in (tw.TransformerWEncoder, tw.TransformerWConditionalEncoder,
                                      tw.TransformerWDecoder))
        wae = type('W', (), {'encoder': _as(enc, nets[0]), 'z2_posterior': _as(post, nets[1]),
                              'decoder': _as(dec, nets[2]), 'n_codes': 128, 'embedding_dim': e})()
        want = len(set(procs)) == 1 and cvae_cf_supported(128, procs[0], 128, 3, heads, e)
        assert WAutoEncoder.fused_ok(wae) == want, (procs, heads, e)


def _as(cls, net):
    """``net``'s attributes on an instance of ``cls`` made without its
    constructor (the gate reads attributes and types only)."""
    obj = object.__new__(cls)
    obj.__dict__.update(net.__dict__)
    return obj


def test_chain_pads_embeddings_to_whole_tiles():
    """The chain's token input to 32-column k tiles and its compress head to
    64-row n tiles: 4 -> 32 / 64, 40 -> 64 / 64, 128 -> 128 / 128."""
    for e, pin, pout in ((4, 32, 64), (40, 64, 64), (128, 128, 128)):
        assert (cvae._pad(e, cvae.IN_TILE), cvae._pad(e, cvae.OUT_TILE)) == (pin, pout)


DECODER_WIDTHS = (64, 77, 300, 500, 512)


def _conv_classes():
    """Every length 1-4 and every order class of the decoder's widths:
    strictly shrinking after the first, flat, growing."""
    out = set()
    for n in range(1, 5):
        for dims in itertools.product(DECODER_WIDTHS, repeat=n):
            if n <= 2 or len(set(dims)) == n or dims[1] == dims[2]:
                out.add(dims)
    return sorted(out)


@pytest.mark.parametrize('w_dim', [1024, 512, 960])
@pytest.mark.parametrize('g', [1, 2, 8, 16])
def test_pcgen_gate_equals_fused_eval_ok(no_vmem, w_dim, g):
    """``pcgen.supported`` against ``pcgen_fused_supported`` at 2048 and
    2000 points for every width class; the flagship's shapes go to its own
    kernel."""
    from pccf.kernels.pallas_pcgen import pcgen_fused_supported

    for conv in _conv_classes():
        for n in (2048, 2000):
            want = pcgen_fused_supported(n, w_dim, conv, g)
            assert pcgen.supported(n, w_dim, conv, g) == want, (n, w_dim, conv, g)
    assert pcgen.flagship(64, (1024, 1024, 256, 16), 8) and not pcgen.flagship(200, (1024, 500, 300, 77), 8)


@pytest.mark.parametrize('act,ok', [('ReLU', True), ('', True), ('LeakyReLU', True), ('GELU', False)])
def test_pcgen_gate_reads_the_activation(act, ok):
    from pccf_torch.nn.decoders import build_decoder

    dec = build_decoder(tc.AutoEncoderConfig(decoder=tc.DecoderConfig(act_name=act)))
    assert dec.fused_ok(2048) == ok


@pytest.mark.parametrize('c', [1, 3, 16, 17, 34, 130, 511, 512])
@pytest.mark.parametrize('n', [256, 2048, 2000])
def test_pool_kernels_cover_the_jax_pool_gate(no_vmem, c, n):
    """``gather_pool_supported`` (any width, points in 256-row tiles) within
    the card's pools, which pad the width to four channels and take any
    points up to their row limit."""
    from pccf.kernels.pallas_gather import gather_pool_supported

    padded = c + (-c % 4)
    if gather_pool_supported(n, c):
        assert gather._pool_covers(8, n, padded) and gather._slot_scatter_covers(8, n, padded)
    assert gather._pool_covers(8, n, padded)


@pytest.mark.parametrize('c', [1, 17, 130])
def test_pool_channel_padding_is_exact(c):
    """Zero channels appended and cropped leave every pool, the slot and the
    slot scatter bit-equal: each channel is reduced on its own."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((2, 64, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, (2, 64, 5)).astype(np.int32))
    xp = gather._pad4(x)
    assert xp.shape[-1] % 4 == 0 and torch.equal(xp[..., :c], x) and not xp[..., c:].any()
    assert torch.equal(gather._crop(ops.graph_max_pool(xp, idx), c), ops.graph_max_pool(x, idx))
    out, slots = ops.graph_max_pool_slots_strict(xp, idx)
    want, want_slots = ops.graph_max_pool_slots_strict(x, idx)
    assert torch.equal(gather._crop(out, c), want) and torch.equal(gather._crop(slots, c), want_slots)
    g = torch.from_numpy(rng.standard_normal((2, 64, c)).astype(np.float32))
    got = ops.scatter_add_slots(gather._pad4(g), idx, gather._pad4(want_slots), 64)
    assert torch.equal(gather._crop(got, c), ops.scatter_add_slots(g, idx, want_slots, 64))
    assert torch.equal(gather._crop(ops.graph_sum_pool_slot_order(xp, idx), c),
                       ops.graph_sum_pool_slot_order(x, idx))


@pytest.mark.parametrize('ff', [137, 1000, 700, 96, 1024])
@pytest.mark.parametrize('decoder', [False, True])
def test_ff_padding_is_exact_and_kept(ff, decoder):
    """A layer whose FF width is off the GEMM's 64-column tiles packs a
    zero-padded copy (zero rows, bias and columns: the exact GELU of 0 is 0):
    the padded stack equals the layer; the copy is made once and made again
    only when a parameter changes; a 64-multiple width packs the live
    weights."""
    from pccf_torch.nn.layers import TransformerDecoderLayer, TransformerEncoderLayer

    layer = (TransformerDecoderLayer if decoder else TransformerEncoderLayer)(128, 16, ff, gelu_exact)
    init_from_seed(layer, ff)
    layer.eval()
    pack = (wformer.pack_decoder if decoder else wformer.pack_encoder)([layer])
    width = -(-ff // 64) * 64
    assert pack[0]['w1'].shape == (width, 128) and pack[0]['w2'].shape == (128, width)
    assert (pack[0]['w1'].data_ptr() == layer.dense_0.weight.data_ptr()) == (ff == width)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 128, 128)).astype(np.float32))
    with torch.no_grad():
        want = layer(x, x) if decoder else layer(x)
        got = wformer.plain_decoder(x, x, pack, 16) if decoder else wformer.plain_encoder(x, pack, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = (wformer.pack_decoder if decoder else wformer.pack_encoder)([layer])
    assert again[0]['w1'].data_ptr() == pack[0]['w1'].data_ptr()
    with torch.no_grad():
        layer.dense_1.weight.mul_(2.0)
    changed = (wformer.pack_decoder if decoder else wformer.pack_encoder)([layer])
    assert (changed[0]['w2'].data_ptr() == pack[0]['w2'].data_ptr()) == (ff == width)
    torch.testing.assert_close(changed[0]['w2'][:, :ff], layer.dense_1.weight.detach())


def test_general_pcgen_operands_are_the_pack():
    """The general kernel reads the pack's fp32 weights as they are: no copy."""
    g, dims = 3, (256, 100, 40)
    pack = pcgen.PCGenPack(map_w=torch.randn(256, 16), map_b=torch.randn(256),
                           layer_ws=tuple(torch.randn(g, dims[i + 1], dims[i]) for i in range(2)),
                           layer_bs=tuple(torch.randn(g, dims[i + 1]) for i in range(2)),
                           head_w=torch.randn(g, 3, 40), head_b=torch.randn(g, 3), att_w=torch.randn(g, g * 40),
                           att_b=torch.randn(g))
    map_w, _, layers, head_w, *_ = pack.general_operands()
    assert pack.dims() == dims and map_w.data_ptr() == pack.map_w.data_ptr()
    assert [t.data_ptr() for t in layers] == [t.data_ptr() for t in (*pack.layer_ws, *pack.layer_bs)]
    assert head_w.data_ptr() == pack.head_w.data_ptr()

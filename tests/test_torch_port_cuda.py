"""pccf_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one (a CUDA
kernel has no interpret mode).  The file imports neither JAX nor the tests'
conftest helpers, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerances: kNN neighbour sets equal up to near-ties (a differing neighbour
must be as near, in float64, within 1e-5 of the squared distance scale),
with the lowest index first on exact duplicates, and the same lists index for
index whatever the candidate split or the batch; max-pool bit-exact; pcgen_mix
rel-L2 2e-3 (fp16 weights and product inputs, ~3e-4 at the flagship, where
a bf16 version read ~4e-3); the CVAE chain and the transformer stacks rel-L2
1e-4 (3xTF32 products); the stacks' GEMM against the float64 product and
epilogue rel-L2 5e-6 (3xTF32 drops the small-small term, ~2^-22 of each
product; the tensor cores sum only each 32-wide k tile, whose partial sums
add in fp32 rounded to nearest; one TF32 product alone misses by ~3e-4),
the TF32 weight split bit-exact, the streaming attention against the exact softmax
1e-5 (the online softmax rescales its fp32 sums);
gather, sum-pool and pool-with-slot bit-exact except sum-pool's order of
addition (1e-5); the slot scatter 1e-5 of the largest entry (fp32 atomics
add in an order that changes from run to run); the row scatter 1e-5 of the
largest entry against the plain version on the card and bit-exact against
it on the CPU (both add in ascending edge order), the same on every call;
EMD cost 1e-4 relative and gradients rel-L2 1e-3 (exp2 of the folded level
and the row and column sums recomputed in another order), Chamfer minima
and argmins exact (same float32 squared distances), the same on every call;
the nearest-neighbour minima and argmins exact; Sinkhorn cost 1e-4 relative
and gradients rel-L2 1e-3 (its sums over the pairs in another order, through
twelve updates of the scalings), its Chamfer outputs exact; gradients of the
Chamfer and Sinkhorn losses on the card against the CPU rel-L2 1e-4 (Chamfer:
the same argmins, the scatter-adds in another order) and 1e-3 (Sinkhorn).
"""

import numpy as np
import pytest
import torch

from pccf_torch.kernels import api, chamfer, cvae, emd, gather, knn, ops, pcgen, sinkhorn, wformer

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _randn(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)


def _rel_l2(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize('n,c,k', [(2048, 3, 25), (2048, 64, 20), (2048, 128, 25), (300, 5, 4), (64, 7, 32)])
def test_knn_sets_match_plain(dev, n, c, k):
    x = _randn((2, n, c), n + c, dev)
    got, want = knn.knn_cuda(x, k), ops.knn(x, k)
    assert got.dtype == torch.int32 and got.shape == (2, n, k)
    assert bool((got[..., 0] == torch.arange(n, device=dev)).all())
    same = (torch.sort(got, dim=-1).values == torch.sort(want, dim=-1).values).all(-1)
    assert same.float().mean() >= 0.999

    def dists(idx):  # float64 squared distances of the selected neighbours, sorted
        xd = x.double()
        nb = torch.gather(xd, 1, idx.long().reshape(2, -1, 1).expand(-1, -1, c)).reshape(2, n, k, c)
        return torch.sort(((nb - xd[:, :, None]) ** 2).sum(-1), dim=-1).values

    scale = float(dists(want)[..., -1].mean())
    assert float((dists(got) - dists(want)).abs().max()) <= 1e-5 * scale


def test_knn_duplicates_lowest_index_first(dev):
    x = _randn((1, 256, 3), 1, dev)
    x[0, 100] = x[0, 9]
    x[0, 200] = x[0, 9]
    got = knn.knn_cuda(x, 4)
    for i in (9, 100, 200):
        assert got[0, i, :3].tolist() == [9, 100, 200]
    assert knn.knn_cuda(x, 1)[0, [9, 100, 200], 0].tolist() == [9, 9, 9]


def _knn_agrees(x, got, want, k):
    """Neighbour sets equal up to near-ties: a differing neighbour is as near,
    in float64, within 1e-5 of the squared distance scale."""
    b, n, c = x.shape

    def dists(idx):
        xd = x.double()
        nb = torch.gather(xd, 1, idx.long().reshape(b, -1, 1).expand(-1, -1, c)).reshape(b, n, k, c)
        return torch.sort(((nb - xd[:, :, None]) ** 2).sum(-1), dim=-1).values

    same = (torch.sort(got, dim=-1).values == torch.sort(want, dim=-1).values).all(-1)
    scale = float(dists(want)[..., -1].mean())
    return same.float().mean() >= 0.999 and float((dists(got) - dists(want)).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('k', [1, 4, 20, 25, 32])
@pytest.mark.parametrize('c', [3, 64, 128])
@pytest.mark.parametrize('b', [1, 5, 8, 16])
def test_knn_matches_plain_at_serving_batches(dev, b, c, k):
    """Serving's batches and stage 1's 8: the candidates split across blocks
    at 1 (FMA distances at C = 3, 3xTF32 on the tensor cores at 64 and
    128)."""
    x = _randn((b, 2048, c), 100 * b + c + k, dev)
    got = knn.knn_cuda(x, k)
    assert got.dtype == torch.int32 and got.shape == (b, 2048, k)
    assert bool((got[..., 0] == torch.arange(2048, device=dev)).all())
    assert _knn_agrees(x, got, ops.knn(x, k), k)


@pytest.mark.parametrize('n_splits', [None, 1, 2, 4, 16])
def test_knn_duplicates_straddling_splits(dev, n_splits):
    """Exact duplicates at 100, 130 and 1900 lie in different candidate
    splits (two tiles of 64 a split at batch 1): the lowest index first
    whatever the split, as the plain version's stable sort."""
    x = _randn((1, 2048, 64), 11, dev)
    x[0, 130] = x[0, 100]
    x[0, 1900] = x[0, 100]
    got = knn.knn_cuda(x, 4, n_splits=n_splits)
    for i in (100, 130, 1900):
        assert got[0, i, :3].tolist() == [100, 130, 1900]
    assert _knn_agrees(x, got, ops.knn(x, 4), 4)


@pytest.mark.parametrize('n,c', [(300, 64), (1000, 3), (130, 128)])
def test_knn_tail_tiles_and_splits(dev, n, c):
    """N not a multiple of the 64-point tile, split and unsplit."""
    x = _randn((1, n, c), n + c, dev)
    got = knn.knn_cuda(x, 20)
    assert knn.splits(1, n) > 1
    assert got.equal(knn.knn_cuda(x, 20, n_splits=1))
    assert _knn_agrees(x, got, ops.knn(x, 20), 20)


@pytest.mark.parametrize('c', [3, 128])
def test_knn_lists_do_not_depend_on_the_batch(dev, c):
    """A cloud alone (split 4 ways) and inside a batch of 16 (unsplit) gets
    the same lists, index for index."""
    x = _randn((16, 2048, c), 12 + c, dev)
    batched = knn.knn_cuda(x, 25)
    for i in (0, 7, 15):
        assert knn.knn_cuda(x[i:i + 1].contiguous(), 25).equal(batched[i:i + 1])


def test_graph_max_pool_bit_exact(dev):
    x = _randn((2, 512, 64), 2, dev)
    idx = torch.randint(0, 512, (2, 512, 25), dtype=torch.int32, device=dev)
    assert torch.equal(gather.graph_max_pool_cuda(x, idx), ops.graph_max_pool(x, idx))


PCGEN_REL_L2 = 2e-3  # fp16 products; see the module's docstring


def _pcgen_pack(dev, g=3, dims=(256, 256, 64, 16), dm=8):
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return pcgen.PCGenPack(
        map_w=r(dims[0], dm, scale=0.3), map_b=r(dims[0], scale=0.1),
        layer_ws=tuple(r(g, dims[i + 1], dims[i], scale=dims[i] ** -0.5) for i in range(3)),
        layer_bs=tuple(r(g, dims[i + 1], scale=0.1) for i in range(3)),
        head_w=r(g, 3, dims[-1], scale=0.25), head_b=r(g, 3, scale=0.1),
        att_w=r(g, g * dims[-1], scale=0.1), att_b=r(g, scale=0.1),
    )


@pytest.mark.parametrize('slope', [0.0, 0.2])
def test_pcgen_mix_matches_plain(dev, slope):
    pack = _pcgen_pack(dev)
    m, w = torch.relu(_randn((2, 256, 8), 3, dev)), _randn((2, 256), 4, dev)
    before = pcgen.pcgen_mix_cuda.launches
    got = pcgen.pcgen_mix_cuda(m, w, pack, tau=5.0, act_slope=slope)
    assert pcgen.pcgen_mix_cuda.launches == before + 1
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=slope)) <= PCGEN_REL_L2


def test_pcgen_mix_refuses_shapes_it_does_not_cover(dev):
    m, w = torch.relu(_randn((1, 48, 8), 3, dev)), _randn((1, 256), 4, dev)
    with pytest.raises(ValueError, match='does not cover'):  # D3 = 8: layer 2 is one n16 product
        pcgen.pcgen_mix_cuda(m, w, _pcgen_pack(dev, dims=(256, 256, 64, 8)), tau=5.0, act_slope=0.0)
    with pytest.raises(ValueError, match='does not cover'):  # D2 = 96: not a warpgroup-split chunk
        pcgen.pcgen_mix_cuda(m, w, _pcgen_pack(dev, dims=(256, 192, 96, 16)), tau=5.0, act_slope=0.0)


@pytest.mark.parametrize('n', [48, 200])
def test_pcgen_mix_masks_the_tail_tile(dev, n):
    """N not a multiple of the 64-point tile: the rows past N are computed on
    zeros and not stored."""
    pack = _pcgen_pack(dev)
    m, w = torch.relu(_randn((2, n, 8), 3, dev)), _randn((2, 256), 4, dev)
    got = pcgen.pcgen_mix_cuda(m, w, pack, tau=5.0, act_slope=0.0)
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)) <= PCGEN_REL_L2


@pytest.mark.parametrize('b', [1, 16])
def test_pcgen_mix_matches_plain_at_the_flagship(dev, b):
    """1024-1024-256-16, 8 components, map input 64."""
    pack = _pcgen_pack(dev, g=8, dims=(1024, 1024, 256, 16), dm=64)
    m, w = torch.relu(_randn((b, 2048, 64), 5, dev)), _randn((b, 1024), 6, dev)
    got = pcgen.pcgen_mix_cuda(m, w, pack, tau=5.0, act_slope=0.0)
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)) <= PCGEN_REL_L2


def _layer(d, f, gen, dev, decoder=False):
    def r(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    p = {'ln1_w': 1 + r(d, scale=0.1), 'ln1_b': r(d, scale=0.1), 'ln2_w': 1 + r(d, scale=0.1),
         'ln2_b': r(d, scale=0.1), 'w1': r(f, d, scale=d ** -0.5), 'b1': r(f, scale=0.1),
         'w2': r(d, f, scale=f ** -0.5), 'b2': r(d, scale=0.1)}
    for name in ('q', 'k', 'v', 'o', *(('xq', 'xk', 'xv', 'xo') if decoder else ())):
        p.update({f'w{name}': r(d, d, scale=d ** -0.5), f'b{name}': r(d, scale=0.1)})
    if decoder:
        p.update({'lnx_w': 1 + r(d, scale=0.1), 'lnx_b': r(d, scale=0.1)})
    return p


def _cvae_pack(dev, t, d=128, e=4, n_classes=2):
    gen = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return cvae.CVAEPack(
        win1=r(e, d, scale=0.5), add1=r(t, d), enc1=[_layer(d, 256, gen, dev)],
        aw=r(d, d, scale=d ** -0.5), ab=r(t, d), win2=r(e, d, scale=0.5), add2=r(t, d),
        enc2=[_layer(d, 128, gen, dev)], bw=r(d, d, scale=d ** -0.5), addd=r(t, d),
        dec=[_layer(d, 128, gen, dev, decoder=True) for _ in range(2)],
        wcomp=r(d, e, scale=d ** -0.5), bcomp=r(e, scale=0.1), prior_z2p=r(n_classes, t, d, scale=0.1),
        wp=r(n_classes, d, scale=0.1), bp=r(d, scale=0.1), heads=(2, 2, 2),
    )


def test_cvae_chain_matches_plain(dev):
    pack = _cvae_pack(dev, 128)
    x = _randn((3, 128, 4), 5, dev)
    probs = torch.softmax(_randn((3, 2), 6, dev), -1)
    got = cvae.cvae_cf_cuda(x, probs, pack)
    assert got.shape == (3, 128, 4)
    assert _rel_l2(got, ops.cvae_cf(x, probs, pack)) <= 1e-4


def test_cvae_chain_refuses_shapes_it_does_not_cover(dev):
    pack = _cvae_pack(dev, 96)  # 96 tokens: not 64-row attention tiles
    probs = torch.softmax(_randn((2, 2), 6, dev), -1)
    with pytest.raises(ValueError, match='does not cover'):
        cvae.cvae_cf_cuda(_randn((2, 96, 4), 5, dev), probs, pack)


def test_failed_gates_raise_on_cuda(dev):
    """A W-autoencoder whose fused-chain gate fails runs its nets one by one
    on the card, each stack through the wformer kernels, and agrees with the
    CPU; a PCGen decoder whose gate fails has no kernel path on the card and
    raises instead of running the plain modules there."""
    from pccf_torch.data.structures import WInputs
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.decoders import PCGenDecoder
    from pccf_torch.nn.layers import gelu_exact, init_from_seed, relu

    wae = WAutoEncoder(  # a W-encoder wider than the decoder: the chain's gate fails
        encoder=tw.TransformerWEncoder(4, 8, 128, 256, 4, (256,), gelu_exact),
        decoder=tw.TransformerWDecoder(4, 8, 6, 128, 128, 2, (128, 256), gelu_exact),
        z2_prior=tw.ConditionalPrior(3, 128, 6),
        z2_posterior=tw.TransformerWConditionalEncoder(4, 3, 6, 128, 128, 2, (128,), gelu_exact),
        n_codes=128, embedding_dim=4, z1_dim=8, z2_dim=6, n_classes=3,
    ).eval()
    init_from_seed(wae, 0)
    assert not wae.fused_ok()
    args = (_randn((2, 512), 1, 'cpu'), _randn((2, 3), 2, 'cpu')), _randn((128, 8, 4), 3, 'cpu')
    with torch.no_grad():
        want = wae.generate_counterfactual(WInputs(*args[0]), args[1], 1)
        api.reset_launch_counts()
        got = wae.to(dev).generate_counterfactual(WInputs(*(a.to(dev) for a in args[0])), args[1].to(dev), 1)
    counts = api.launch_counts()
    assert (counts['wformer_encoder'], counts['wformer_decoder'], counts['cvae_cf']) == (2, 1, 0)
    assert _rel_l2(got.w_recon.cpu(), want.w_recon) <= 1e-4
    assert (got.idx.cpu() == want.idx).float().mean() >= 0.99

    dec = PCGenDecoder(w_dim=128, sample_dim=4, n_components=1, map_dims=(8,), conv_dims=(128, 64, 16), tau=5.0,
                       act=relu).to(dev).eval()
    assert not dec.fused_ok()
    with pytest.raises(NotImplementedError, match='pcgen_mix gate'):
        dec(_randn((2, 128), 4, dev), _randn((2, 64, 4), 5, dev))


@pytest.mark.parametrize('why', ['tokens', 'activation', 'heads', 'ff'])
def test_failed_stack_gates_raise_on_cuda(dev, why):
    """A W-net whose wformer gate fails (96 tokens, LeakyReLU, proj 256 with
    8 heads of 32, an FF width of 96) runs its layers one by one in training
    on the card, and in eval raises the gate's error before any launch."""
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import default_act, gelu_exact, init_from_seed

    t, d, heads, ff, act = {
        'tokens': (96, 128, 2, (128,), gelu_exact), 'activation': (128, 128, 2, (128,), default_act),
        'heads': (128, 256, 8, (256,), gelu_exact), 'ff': (128, 128, 2, (96,), gelu_exact)}[why]
    nets = [tw.TransformerWEncoder(4, 8, t, d, heads, ff, act),
            tw.TransformerWDecoder(4, 8, 6, t, d, heads, ff, act)]
    inputs = [(_randn((2, t, 4), 1, dev),), (_randn((2, 1, 8), 2, dev), _randn((2, t, 6), 3, dev))]
    for net, args in zip(nets, inputs):
        init_from_seed(net, 0)
        net = net.to(dev)
        api.reset_launch_counts()
        with torch.no_grad():
            assert torch.isfinite(net.train()(*args, torch.Generator(device=dev).manual_seed(0))).all()
            with pytest.raises(NotImplementedError, match='wformer stack gate'):
                net.eval()(*args)
        assert set(api.launch_counts().values()) == {0}


def test_cvae_with_heads_of_32_raises_on_cuda(dev):
    """A W-autoencoder whose nets have 32-wide heads: its chain gate and its
    nets' stack gates fail; in eval on the card the counterfactual raises the
    gate's error before any launch, and the training forward runs through
    the plain layers."""
    from pccf_torch.data.structures import WInputs
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact, init_from_seed

    wae = WAutoEncoder(
        encoder=tw.TransformerWEncoder(4, 8, 128, 128, 4, (128,), gelu_exact),
        decoder=tw.TransformerWDecoder(4, 8, 6, 128, 128, 4, (128,), gelu_exact),
        z2_prior=tw.ConditionalPrior(3, 128, 6),
        z2_posterior=tw.TransformerWConditionalEncoder(4, 3, 6, 128, 128, 4, (128,), gelu_exact),
        n_codes=128, embedding_dim=4, z1_dim=8, z2_dim=6, n_classes=3,
    )
    init_from_seed(wae, 0)
    wae = wae.to(dev)
    assert not wae.fused_ok()
    inputs, book = WInputs(_randn((2, 512), 1, dev), _randn((2, 3), 2, dev)), _randn((128, 8, 4), 3, dev)
    api.reset_launch_counts()
    with torch.no_grad():
        out = wae.train()(inputs, book, generator=torch.Generator(device=dev).manual_seed(0))
        assert torch.isfinite(out.w_recon).all()
        with pytest.raises(NotImplementedError, match='wformer stack gate'):
            wae.eval().generate_counterfactual(inputs, book, 1)
    assert set(api.launch_counts().values()) == {0}


@pytest.mark.parametrize('decoder', [False, True])
def test_wformer_stacks_match_plain(dev, decoder):
    """Mixed FF widths (256, then 128); the decoder's memory has its own rows."""
    gen = torch.Generator().manual_seed(2)
    pack = [_layer(128, f, gen, dev, decoder) for f in (256, 128)]
    x, memory = _randn((3, 128, 128), 6, dev), _randn((3, 128, 128), 7, dev)
    api.reset_launch_counts()
    if decoder:
        got, want = wformer.wformer_decoder_cuda(x, memory, pack, 2), wformer.plain_decoder(x, memory, pack, 2)
    else:
        got, want = wformer.wformer_encoder_cuda(x, pack, 2), wformer.plain_encoder(x, pack, 2)
    assert got.shape == (3, 128, 128) and not torch.equal(got, x)
    assert _rel_l2(got, want) <= 1e-4
    assert api.launch_counts()['wformer_decoder' if decoder else 'wformer_encoder'] == 1


def test_wformer_refuses_shapes_it_does_not_cover(dev):
    gen = torch.Generator().manual_seed(3)
    pack = [_layer(128, 128, gen, dev)]
    with pytest.raises(ValueError, match='does not cover'):  # more keys than the attention kernel holds
        wformer.wformer_encoder_cuda(_randn((1, 320, 128), 8, dev), pack, 2)
    with pytest.raises(ValueError, match='does not cover'):  # heads of 32
        wformer.wformer_encoder_cuda(_randn((1, 128, 128), 8, dev), pack, 4)


def test_w_nets_launch_stacks_in_eval_only(dev):
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact, init_from_seed

    net = tw.TransformerWEncoder(4, 8, 128, 128, 2, (256,), gelu_exact, (0.1,))
    init_from_seed(net, 1)
    net = net.to(dev)
    x = _randn((2, 128, 4), 9, dev)
    api.reset_launch_counts()
    with torch.no_grad():
        net.eval()
        out = net(x)
        assert api.launch_counts()['wformer_encoder'] == 1
        torch.testing.assert_close(out, net.cpu()(x.cpu()).to(dev), rtol=1e-4, atol=1e-4)
        net.to(dev).train()
        net(x, torch.Generator(device=dev).manual_seed(0))
    assert api.launch_counts()['wformer_encoder'] == 1  # training runs the plain layers, with dropout


def test_dispatch_sends_cuda_tensors_to_kernels(dev):
    api.reset_launch_counts()
    x = _randn((1, 256, 16), 7, dev)
    api.graph_max_pool(x, api.knn(x, 8))
    assert api.launch_counts()['knn'] == 1 and api.launch_counts()['graph_max_pool'] == 1


def test_wrappers_reject_bad_inputs(dev):
    x = _randn((1, 64, 6), 8, dev)
    with pytest.raises(ValueError):
        knn.knn_cuda(x, 33)  # above the kernel's k limit
    with pytest.raises(ValueError):
        gather.graph_max_pool_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32, device=dev))  # F % 4
    with pytest.raises(ValueError):
        knn.knn_cuda(x.double(), 4)


def _graph(b, n, k, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (b, n, k), generator=gen, dtype=torch.int32).to(dev)


def _max_rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _scatter_graph(graph, b, n, k, dev, seed):
    """``idx (B, M, k)`` into n rows: random, with a hub row (in-degree >= 300),
    with rows no edge reaches, or the k = 1 layout of the gather backward
    (N·4 rows of one neighbour)."""
    if graph == 'k1_flat':
        return _graph(b, n, 4, dev, seed).reshape(b, n * 4, 1)
    idx = _graph(b, n, k, dev, seed)
    if graph == 'hub':
        idx[:, :1500, 2] = 77
        idx[:, 3, 5:9] = 78  # one centre lists a neighbour four times
    elif graph == 'empty_rows':
        idx[(idx >= 1000) & (idx < 1200)] = 999
    return idx


@pytest.mark.parametrize('c,k,graph', [(3, 4, 'random'), (128, 25, 'random'), (512, 25, 'hub'), (3, 25, 'hub'),
                                       (512, 25, 'empty_rows'), (6, 25, 'empty_rows'), (3, 1, 'k1_flat')])
def test_gather_and_row_scatter_match_plain(dev, c, k, graph):
    x = _randn((2, 2048, c), 10, dev)
    idx = _graph(2, 2048, 4 if graph == 'k1_flat' else k, dev, 11)
    assert torch.equal(gather.gather_neighbors_cuda(x, idx), ops.gather_neighbors(x, idx))
    sidx = _scatter_graph(graph, 2, 2048, k, dev, 11)
    g = _randn((2, sidx.shape[1], c), 12, dev)
    got = gather.scatter_add_rows_cuda(g, sidx, 2048)
    assert _max_rel(got, ops.scatter_add_rows(g, sidx, 2048)) <= 1e-5
    # the transposed graph sums each row in ascending edge order, as index_add_ on the CPU does
    assert torch.equal(got.cpu(), ops.scatter_add_rows(g.cpu(), sidx.cpu(), 2048))
    assert torch.equal(got, gather.scatter_add_rows_cuda(g, sidx, 2048))  # the same on every call
    if graph == 'empty_rows':
        assert not got[:, 1000:1200].any()


@pytest.mark.parametrize('f', [64, 256])
def test_pool_with_slot_and_slot_scatter_match_plain(dev, f):
    x = _randn((2, 2048, f), 13, dev)
    x[:, 40] = x[:, 7]  # exact ties between rows
    idx = _graph(2, 2048, 25, dev, 14)
    idx[..., 3], idx[..., 9] = 7, 40
    out, slots = gather.graph_max_pool_src_cuda(x, idx)
    want, want_slots = ops.graph_max_pool_slots(x, idx)
    assert torch.equal(out, want) and torch.equal(slots, want_slots)
    assert torch.equal(out, gather.graph_max_pool_cuda(x, idx))
    g = _randn((2, 2048, f), 15, dev)
    assert _max_rel(gather.scatter_add_slots_cuda(g, idx, slots, 2048), ops.scatter_add_slots(g, idx, slots, 2048)) <= 1e-5


def test_sum_pool_matches_plain(dev):
    x = _randn((2, 2048, 256), 16, dev)
    idx = _graph(2, 2048, 25, dev, 17)
    assert _max_rel(gather.graph_sum_pool_cuda(x, idx), ops.graph_sum_pool(x, idx)) <= 1e-5


@pytest.mark.parametrize('n,m', [(1024, 1024), (512, 768)])
def test_chamfer_match_cost_matches_plain(dev, n, m):
    x1 = _randn((2, n, 3), 18, dev) * 0.5
    x2 = _randn((2, m, 3), 19, dev) * 0.5
    got, want = emd.chamfer_match_cost_cuda(x1, x2), emd.plain(x1, x2)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
    assert _rel_l2(got[1], want[1]) <= 1e-3 and _rel_l2(got[2], want[2]) <= 1e-3
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a, b)
    alone = emd.chamfer_match_cost_cuda(x1, x2, with_chamfer=False)
    assert len(alone) == 3 and torch.equal(alone[0], got[0])
    again = emd.chamfer_match_cost_cuda(x1, x2)  # no atomics: the same bits on every call
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_on_cuda_never_runs_plain(dev, monkeypatch):
    """Forward and backward of every new autograd function launch kernels on
    CUDA tensors; the plain versions are not called."""
    def boom(*args, **kwargs):
        raise AssertionError('a plain version ran on CUDA tensors')

    for name in ('gather_neighbors', 'graph_max_pool_slots', 'scatter_add_slots', 'graph_sum_pool',
                 'scatter_add_rows', 'emd_forward', 'nn_distance'):
        monkeypatch.setattr(ops, name, boom)
    api.reset_launch_counts()
    x = _randn((2, 512, 64), 20, dev).requires_grad_(True)
    idx = api.knn(x, 8)
    y = api.graph_max_pool(x, idx).sum() + api.graph_sum_pool(x, idx).sum()
    cloud = _randn((2, 512, 3), 21, dev).requires_grad_(True)
    cham, cost = api.chamfer_match_cost(api.graph_filtering(cloud), _randn((2, 512, 3), 22, dev))
    (y + cham.sum() + cost.sum() + api.match_cost(cloud, _randn((2, 512, 3), 23, dev)).sum()).backward()
    torch.cuda.synchronize()
    counts = api.launch_counts()
    for name in ('gather_neighbors', 'scatter_add_rows', 'graph_max_pool_src', 'scatter_add_slots',
                 'graph_sum_pool'):
        assert counts[name] >= 1, name
    assert counts['chamfer_match_cost'] == 2 and counts['graph_max_pool'] == 0
    assert bool(torch.isfinite(x.grad).all()) and bool(torch.isfinite(cloud.grad).all())


def test_new_wrappers_refuse_shapes_they_do_not_cover(dev):
    x = _randn((1, 64, 6), 24, dev)
    idx = _graph(1, 64, 4, dev, 25)
    for call in (lambda: gather.graph_max_pool_src_cuda(x, idx), lambda: gather.graph_sum_pool_cuda(x, idx)):
        with pytest.raises(ValueError, match='does not cover'):  # F % 4
            call()
    with pytest.raises(ValueError, match='does not cover'):  # slots are uint8
        gather.graph_max_pool_src_cuda(_randn((1, 300, 8), 26, dev), _graph(1, 300, 256, dev, 27))
    with pytest.raises(ValueError):
        gather.gather_neighbors_cuda(x, idx.long())
    with pytest.raises(ValueError):
        emd.chamfer_match_cost_cuda(x, x)  # not 3-D points
    with pytest.raises(ValueError, match='does not cover'):  # rows past the transposed graph's 65536
        gather.scatter_add_rows_cuda(x, idx, 70000)


def _clouds(n, m, seed, dev):
    x = _randn((2, n, 3), seed, dev) * 0.5
    y = _randn((2, m, 3), seed + 1, dev) * 0.5
    y[:, 5] = y[:, 1]  # exact ties: the lowest index wins
    x[:, 9] = x[:, 2]
    return x, y


@pytest.mark.parametrize('n,m', [(2048, 2048), (2048, 1024), (300, 77)])
def test_nn_distance_matches_plain_exactly(dev, n, m):
    x, y = _clouds(n, m, 30, dev)
    got, want = chamfer.nn_distance_cuda(x, y), chamfer.plain(x, y)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool((got[1] == 5).any()) and not bool((got[3] == 9).any())


@pytest.mark.parametrize('n,m', [(1024, 1024), (1024, 512), (300, 77)])
def test_sinkhorn_cost_matches_plain(dev, n, m):
    x, y = _clouds(n, m, 31, dev)
    got, want = sinkhorn.sinkhorn_cost_cuda(x, y), sinkhorn.plain(x, y)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
    assert _rel_l2(got[1], want[1]) <= 1e-3 and _rel_l2(got[2], want[2]) <= 1e-3
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a, b)


def _loss_grads(fn, x, y):
    xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = fn(xs, ys)
    out = out if isinstance(out, tuple) else (out,)
    sum((i + 1.0) * (o * torch.linspace(0.5, 1.5, o.shape[0], device=o.device)).sum()
        for i, o in enumerate(out)).backward()
    return [o.detach().cpu() for o in out], xs.grad.cpu(), ys.grad.cpu()


@pytest.mark.parametrize('loss', ['chamfer', 'chamfer_sinkhorn'])
def test_loss_gradients_on_cuda_match_cpu(dev, loss):
    fn = {'chamfer': api.chamfer, 'chamfer_sinkhorn': api.chamfer_sinkhorn_cost}[loss]
    x, y = _clouds(512, 384, 32, 'cpu')
    api.reset_launch_counts()
    got = _loss_grads(fn, x.to(dev), y.to(dev))
    counts = api.launch_counts()
    want = _loss_grads(fn, x, y)
    assert counts['sinkhorn_cost' if 'sinkhorn' in loss else 'nn_distance'] == 1
    assert sum(counts.values()) == 1
    tol = 1e-3 if 'sinkhorn' in loss else 1e-4
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=tol, atol=0.0)
    assert _rel_l2(got[1], want[1]) <= tol and _rel_l2(got[2], want[2]) <= tol


def test_new_losses_never_run_plain_on_cuda(dev, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('a plain version ran on CUDA tensors')

    for name in ('nn_distance', 'sinkhorn_forward', 'pair_square_distance'):
        monkeypatch.setattr(ops, name, boom)
    x, y = _clouds(256, 256, 33, dev)
    x.requires_grad_(True)
    api.reset_launch_counts()
    cham, cost = api.chamfer_sinkhorn_cost(x, y)
    (cham.sum() + cost.sum() + api.chamfer(x, y).sum()).backward()
    torch.cuda.synchronize()
    assert api.launch_counts()['nn_distance'] == 1 and api.launch_counts()['sinkhorn_cost'] == 1
    assert bool(torch.isfinite(x.grad).all())


def test_new_wrappers_reject_bad_inputs(dev):
    x = _randn((1, 64, 3), 34, dev)
    for call in (chamfer.nn_distance_cuda, sinkhorn.sinkhorn_cost_cuda):
        with pytest.raises(ValueError):
            call(_randn((1, 64, 4), 35, dev), x)  # not 3-D points
        with pytest.raises(ValueError):
            call(x, _randn((2, 64, 3), 36, dev))  # batches differ
        with pytest.raises(ValueError):
            call(x.double(), x.double())


# ------------------------------------------------ the stacks' GEMM and attention


def _gemm_case(m, n, k, groups, seed, dev):
    a = _randn((m, k), seed, dev)
    wts = [_randn((n, k), seed + 1 + g, dev) * k ** -0.5 for g in range(groups)]
    biases = [_randn((n,), seed + 11 + g, dev) for g in range(groups)]
    return a, wts, biases, wformer.Stacks(1, m, k, dev)


@pytest.mark.parametrize('k', [32, 512, 1024])
@pytest.mark.parametrize('n', [64, 512, 1024])
@pytest.mark.parametrize('m', [64, 256, 4096, 8192])
def test_gemm_matches_float64(dev, m, n, k):
    """Every tile shape the launch picks (64x64, 128x64, 128x128) over the
    stacks' M, N and K, with a bias."""
    a, (wt,), (bias,), stacks = _gemm_case(m, n, k, 1, m + n + k, dev)
    out = torch.empty(m, n, device=dev)
    stacks.gemm(a, [wt], [bias], [out])
    assert _rel_l2(out.double(), a.double() @ wt.double().T + bias.double()) <= 5e-6


@pytest.mark.parametrize('epilogue', ['gelu', 'res', 'res_rows', 'alias', 'grouped'])
@pytest.mark.parametrize('m', [256, 8192])
def test_gemm_epilogues_match_float64(dev, epilogue, m):
    """Exact GELU; a residual; one broadcast over ``res_rows`` rows (the
    chain's positional tables); ``out`` aliasing ``res`` (the in-place
    residual stream); and a grouped q/k/v launch, three weights, biases and
    outputs, with no bias on the residual cases as the chain's input products."""
    n, k = 512, 512
    groups = 3 if epilogue == 'grouped' else 1
    a, wts, biases, stacks = _gemm_case(m, n, k, groups, 40 + m, dev)
    want = [a.double() @ w.double().T for w in wts]
    outs = [torch.empty(m, n, device=dev) for _ in wts]
    if epilogue == 'gelu':
        stacks.gemm(a, wts, biases, outs, gelu=True)
        want = [torch.nn.functional.gelu(want[0] + biases[0].double())]
    elif epilogue == 'grouped':
        stacks.gemm(a, wts, biases, outs)
        assert len({o.data_ptr() for o in outs}) == 3
        want = [w + b.double() for w, b in zip(want, biases)]
    else:
        rows = 256 if epilogue == 'res_rows' else m
        res = _randn((rows, n), 50, dev)
        want = [want[0] + res.double().repeat(m // rows, 1)]
        if epilogue == 'alias':
            outs = [res]
        stacks.gemm(a, wts, [None], outs, res, res_rows=rows if epilogue == 'res_rows' else 0)
    for got, ref in zip(outs, want):
        assert _rel_l2(got.double(), ref) <= 5e-6


def test_gemm_refuses_shapes_it_does_not_cover(dev):
    a, (wt,), (bias,), stacks = _gemm_case(96, 64, 32, 1, 60, dev)
    with pytest.raises(ValueError, match='does not cover'):  # M not a multiple of 64
        stacks.gemm(a, [wt], [bias], [torch.empty(96, 64, device=dev)])
    a, wts, biases, stacks = _gemm_case(64, 64, 32, 4, 61, dev)
    with pytest.raises(ValueError, match='does not cover'):  # four groups
        stacks.gemm(a, wts, biases, [torch.empty(64, 64, device=dev) for _ in wts])


def test_tf32_split_kernel_is_bit_exact(dev):
    ws = [_randn((512, 512), 70, dev), _randn((1024, 512), 71, dev) * 1e-3, _randn((64, 32), 72, dev) * 1e4]
    small = wformer.split_small(ws)
    for w in ws:
        assert torch.equal(small[w.data_ptr()], wformer.tf32_split(w)[1])


@pytest.mark.parametrize('t_k', [64, 128, 256])
@pytest.mark.parametrize('t_q', [64, 128, 256])
def test_attention_matches_plain(dev, t_q, t_k):
    """Queries read from a (rows, 3d) buffer and keys and values from a
    (rows, 2d) one, each at its row stride, as a grouped projection could lay
    them out; two heads of 64."""
    b, heads, d = 3, 2, 128
    qbuf, kvbuf = _randn((b * t_q, 3 * d), t_q, dev), _randn((b * t_k, 2 * d), t_k + 1, dev)
    q, k, v = qbuf[:, d: 2 * d], kvbuf[:, :d], kvbuf[:, d:]
    out = torch.empty(b * t_q, d, device=dev)
    wformer.Stacks(b, t_q, d, dev).attend(q, k, v, out, heads)
    want = ops.attention(q.reshape(b, t_q, d), k.reshape(b, t_k, d), v.reshape(b, t_k, d), heads)
    assert _rel_l2(out.reshape(b, t_q, d), want) <= 1e-5

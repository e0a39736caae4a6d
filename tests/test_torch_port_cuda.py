"""pccf_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one (a CUDA
kernel has no interpret mode).  The file imports neither JAX nor the tests'
conftest helpers, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerances: kNN neighbour sets equal up to near-ties (a differing neighbour
must be as near, in float64, within 1e-5 of the squared distance scale),
with the lowest index first on exact duplicates, and the same lists index for
index whatever the candidate split or the batch; on clouds with NaN points
(a NaN after every number) index for index the plain version's on integer
coordinates, which every route's distances hold exactly; max-pool bit-exact; pcgen_mix
rel-L2 2e-3 (fp16 weights and product inputs, ~3e-4 at the flagship, where
a bf16 version read ~4e-3), and 1e-2 (RECON_REL_L2) where the activations
pass fp16's range and the kernel scales its operands; both PCGen kernels'
partial mode (a rank's share of the expert-parallel decode) the same on
each share's logits and heads and on the shares' mixture; the CVAE chain and the transformer stacks rel-L2
1e-4 (3xTF32 products); the stacks' GEMM against the float64 product and
epilogue rel-L2 5e-6 (3xTF32 drops the small-small term, ~2^-22 of each
product; the tensor cores sum only each 32-wide k tile, whose partial sums
add in fp32 rounded to nearest; one TF32 product alone misses by ~3e-4),
the TF32 weight split bit-exact, the streaming attention against the exact softmax
1e-5 (the online softmax rescales its fp32 sums);
gather, sum-pool and pool-with-slot bit-exact except sum-pool's order of
addition (1e-5) against the plain version on the card, and bit-exact against
the sum in slot order on the CPU, which the kernel keeps at every slice
width; the max-pool bit-exact with NaNs at every slice width, the training
max-pool with NaNs against the strict > rule of the TPU kernel; the slot
scatter bit-exact against its plain version on the CPU (both add in
ascending centre order) at every slice width and row split, the same on
every call; the row scatter 1e-5 of the
largest entry against the plain version on the card and bit-exact against
it on the CPU (both add in ascending edge order), the same on every call;
EMD cost 1e-4 relative and gradients rel-L2 1e-3 (exp2 of the folded level
and the row and column sums recomputed in another order), Chamfer minima
and argmins exact (same float32 squared distances), the same on every call;
the nearest-neighbour minima and argmins exact at every column split its
plan takes, the same on every call; Sinkhorn cost 1e-4 relative and gradients rel-L2 1e-3
(the folded exp2 with the scalings in its exponent, the expanded distances
in the middle sweeps and the sums over the pairs in another order, through
twelve updates of the scalings), its Chamfer outputs exact, the same on
every call; gradients of the
Chamfer and Sinkhorn losses on the card against the CPU rel-L2 1e-4 (Chamfer:
the same argmins, the scatter-adds in another order) and 1e-3 (Sinkhorn);
graph filtering's fused pass: its indices knn_cuda(x, 4)'s index for index,
its output and mean within 1e-5 of the largest of the plain version's on
those indices (expf's ulp, the mean summed in another order), its gradient
rel-L2 1e-5 against the closed-form plain backward, the same on every call;
the server's requests in flight bit-equal to its synchronous ones;
generation on the card against the CPU on the same host draws: codes at
>= 0.99 agreement and the clouds whose codes agree at rel-L2 1e-2 (the fp16
PCGen kernel, RECON_REL_L2), the decoder stack on a memory of one z1 row
broadcast over the tokens at 1e-4 like every stack; the auction EMD's
assignment, nearest indices and counts bit-equal to its plain version (the
same squared distances and the same float operations in each bid), its
distances equal, with its state in shared memory and in global scratch, its
gradient rel-L2 1e-6 against the CPU; api.nn_distance's outputs bit-exact
inside the kernel's gate and its gradient rel-L2 1e-6 against the CPU; the
serving kernels as torch.ops.pccf ops under torch.library.opcheck on CUDA
tensors; an exported artifact's requests, classification and generation on
the card within 1e-5 of the live server with the same launches, and its CPU
programs within 1e-5 of the same model on the CPU.
"""

import numpy as np
import pytest
import torch

from pccf_torch.kernels import (api, auction_emd, chamfer, cvae, emd, gather, graph_filter, knn, ops, pcgen, sinkhorn,
                                wformer)

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


# ------------------------------------------------------------- NaN clouds
#
# The lists are compared with the plain version's index for index on clouds
# of integer coordinates, whose squared distances every route computes
# exactly (3xTF32 splits an integer below 2^11 with a zero small part), so
# the order is the sort's, ties included; a random cloud's near-ties round
# apart between the kernel and the plain product.


def _nan_grid(b, n, c, seed, dev, cloud=0, points=(5,)):
    """``(B, N, C)`` integer coordinates in [-8, 8] with NaN points of cloud
    ``cloud`` at ``points``."""
    x = torch.from_numpy(np.random.default_rng(seed).integers(-8, 9, (b, n, c)).astype(np.float32))
    x[cloud, list(points), 0] = float('nan')
    return x.to(dev)


@pytest.mark.parametrize('k', [4, 25])
@pytest.mark.parametrize('c', [3, 64, 128])
@pytest.mark.parametrize('b', [1, 5, 16])
def test_knn_nan_cloud_matches_plain(dev, b, c, k):
    """A NaN point of one cloud ranks after every number in every list of
    that cloud, and its own list is 0 .. k-1 (the plain version's stable sort
    puts NaN last); the other clouds get the lists they get without it."""
    x = _nan_grid(b, 2048, c, 300 + 10 * b + c, dev, cloud=b // 2)
    got = knn.knn_cuda(x, k)
    assert torch.equal(got.cpu(), knn.plain(x.cpu(), k))
    assert got[b // 2, 5].tolist() == list(range(k)) and not bool((got[b // 2, :5] == 5).any())
    if b > 1:
        rest = torch.cat([x[:b // 2], x[b // 2 + 1:]]).contiguous()
        assert torch.equal(torch.cat([got[:b // 2], got[b // 2 + 1:]]), knn.knn_cuda(rest, k))


@pytest.mark.parametrize('n_splits', [None, 1, 2, 4, 16])
@pytest.mark.parametrize('where', [(511,), (512,), (0, 1, 2047), (64, 65, 66, 67, 1024)])
def test_knn_nan_at_split_boundaries(dev, where, n_splits):
    """NaN points either side of a split boundary at batch 1 (4 splits of 512
    candidates by default, 16 of 128), several NaN centres, and a run of NaNs
    longer than k = 4: index for index the plain version's, whatever the
    split."""
    for c in (3, 64):
        x = _nan_grid(1, 2048, c, 7 + c, dev, points=where)
        for k in (4, 25):
            got = knn.knn_cuda(x, k, n_splits=n_splits)
            assert torch.equal(got.cpu(), knn.plain(x.cpu(), k))
            for i in where:
                assert got[0, i].tolist() == list(range(k))


def test_knn_nan_random_cloud(dev):
    """A random cloud of one NaN point: the point is in no other list, its
    own list is 0 .. k-1, and the other lists are the plain version's up to
    near-ties."""
    x = _randn((2, 2048, 64), 61, dev)
    x[1, 700, 3] = float('nan')
    got = knn.knn_cuda(x, 25)
    assert got[1, 700].tolist() == list(range(25))
    others = torch.ones(2048, dtype=torch.bool)
    others[700] = False
    assert not bool((got[1, others] == 700).any())
    assert _knn_agrees(x[:1], got[:1], knn.plain(x[:1], 25), 25)
    assert torch.equal(got[1, others], knn.knn_cuda(x[1:], 25)[0, others])


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
    CPU; a PCGen decoder whose gate fails (one component: the JAX gate asks
    for two) runs its modules on the card, as JAX runs its XLA layers, with
    no launch of either PCGen kernel, and agrees with the CPU."""
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
                       act=relu).eval()
    init_from_seed(dec, 1)
    assert not dec.fused_ok()
    args = (_randn((2, 128), 4, 'cpu'), _randn((2, 256, 4), 5, 'cpu'))
    with torch.no_grad():
        want = dec(*args)
        api.reset_launch_counts()
        got = dec.to(dev)(*(a.to(dev) for a in args))
    assert api.launch_counts()['pcgen_mix'] == api.launch_counts()['pcgen_general'] == 0
    assert _rel_l2(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize('why', ['tokens', 'activation', 'heads', 'ff'])
def test_failed_stack_gates_raise_on_cuda(dev, why):
    """A W-net outside JAX's stack gate (96 tokens, LeakyReLU) runs its layers
    one by one on the card in eval, as JAX runs its XLA layers, with no stack
    launch; one inside it that the card's kernels did not cover before (proj
    256 with 8 heads of 32, an FF width of 96) launches its stack kernel.
    Either way it agrees with the CPU, and training runs the layers."""
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import default_act, gelu_exact, init_from_seed

    t, d, heads, ff, act = {
        'tokens': (96, 128, 2, (128,), gelu_exact), 'activation': (128, 128, 2, (128,), default_act),
        'heads': (128, 256, 8, (256,), gelu_exact), 'ff': (128, 128, 2, (96,), gelu_exact)}[why]
    launches = 1 if why in ('heads', 'ff') else 0
    nets = [tw.TransformerWEncoder(4, 8, t, d, heads, ff, act),
            tw.TransformerWDecoder(4, 8, 6, t, d, heads, ff, act)]
    inputs = [(_randn((2, t, 4), 1, 'cpu'),), (_randn((2, 1, 8), 2, 'cpu'), _randn((2, t, 6), 3, 'cpu'))]
    for net, args, name in zip(nets, inputs, ('wformer_encoder', 'wformer_decoder')):
        init_from_seed(net, 0)
        with torch.no_grad():
            want = net.eval()(*args)
            net = net.to(dev)
            cargs = tuple(a.to(dev) for a in args)
            api.reset_launch_counts()
            assert torch.isfinite(net.train()(*cargs, torch.Generator(device=dev).manual_seed(0))).all()
            assert set(api.launch_counts().values()) == {0}
            got = net.eval()(*cargs)
        assert api.launch_counts()[name] == launches
        assert sum(api.launch_counts().values()) == launches
        assert _rel_l2(got.cpu(), want) <= 1e-4


def test_cvae_with_heads_of_32_raises_on_cuda(dev):
    """A W-autoencoder whose nets have 32-wide heads: inside JAX's chain gate,
    so in eval on the card the counterfactual launches the fused chain and
    agrees with its CPU run (codes at >= 0.99), and the training forward runs
    the plain layers with no launch.  Heads 256 wide (one head over 256) are
    inside the gate too: the chain launches the wide attention instance and
    agrees with its CPU run the same way."""
    from pccf_torch.data.structures import WInputs
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact, init_from_seed

    def build(d, heads):
        wae = WAutoEncoder(
            encoder=tw.TransformerWEncoder(4, 8, 128, d, heads, (128,), gelu_exact),
            decoder=tw.TransformerWDecoder(4, 8, 6, 128, d, heads, (128,), gelu_exact),
            z2_prior=tw.ConditionalPrior(3, 128, 6),
            z2_posterior=tw.TransformerWConditionalEncoder(4, 3, 6, 128, d, heads, (128,), gelu_exact),
            n_codes=128, embedding_dim=4, z1_dim=8, z2_dim=6, n_classes=3,
        )
        init_from_seed(wae, 0)
        return wae.eval()

    wae = build(128, 4)
    assert wae.fused_ok()
    inputs, book = WInputs(_randn((2, 512), 1, 'cpu'), _randn((2, 3), 2, 'cpu')), _randn((128, 8, 4), 3, 'cpu')
    with torch.no_grad():
        want = wae.generate_counterfactual(inputs, book, 1)
        wae = wae.to(dev)
        cin, cbook = WInputs(inputs.w_q.to(dev), inputs.logits.to(dev)), book.to(dev)
        api.reset_launch_counts()
        out = wae.train()(cin, cbook, generator=torch.Generator(device=dev).manual_seed(0))
        assert torch.isfinite(out.w_recon).all() and set(api.launch_counts().values()) == {0}
        got = wae.eval().generate_counterfactual(cin, cbook, 1)
    assert api.launch_counts()['cvae_cf'] == 1
    assert _rel_l2(got.w_recon.cpu(), want.w_recon) <= 1e-4
    assert (got.idx.cpu() == want.idx).float().mean() >= 0.99

    wide = build(256, 1)
    assert wide.fused_ok()
    with torch.no_grad():
        want = wide.generate_counterfactual(inputs, book, 1)
        api.reset_launch_counts()
        got = wide.to(dev).generate_counterfactual(cin, cbook, 1)
    assert api.launch_counts()['cvae_cf'] == 1
    assert _rel_l2(got.w_recon.cpu(), want.w_recon) <= 1e-4
    assert (got.idx.cpu() == want.idx).float().mean() >= 0.99


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
    with pytest.raises(ValueError, match='does not cover'):  # 96 tokens: not whole 64-row attention tiles
        wformer.wformer_encoder_cuda(_randn((1, 96, 128), 8, dev), pack, 2)


@pytest.mark.parametrize('d,heads', [(512, 2), (512, 1), (384, 2), (640, 2)])
@pytest.mark.parametrize('decoder', [False, True])
def test_wformer_wide_heads_match_plain(dev, d, heads, decoder):
    """Heads past 128 wide (256, 512, and 192 and 320 with the last chunk
    padded) run the wide attention instance, within the stacks' 1e-4."""
    gen = torch.Generator().manual_seed(4)
    pack = [_layer(d, 256, gen, dev, decoder)]
    x, memory = _randn((2, 128, d), 10, dev), _randn((2, 128, d), 11, dev)
    if decoder:
        got, want = wformer.wformer_decoder_cuda(x, memory, pack, heads), wformer.plain_decoder(x, memory, pack, heads)
    else:
        got, want = wformer.wformer_encoder_cuda(x, pack, heads), wformer.plain_encoder(x, pack, heads)
    assert _rel_l2(got, want) <= 1e-4


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
    with pytest.raises(ValueError):  # int64 indices
        gather.graph_max_pool_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int64, device=dev))
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


@pytest.mark.parametrize('f', [64, 128, 256])
def test_pool_with_slot_and_slot_scatter_match_plain(dev, f):
    """The training max-pool bit-exact in max and slots to the strict > rule
    with NaNs, ties and a hub row, and to the plain version and the eval pool
    without NaNs; its slot scatter bit-equal to the plain version on the CPU
    (both add in ascending centre order) and the same on a second call."""
    x, idx = _pool_case(2, 2048, f, 25, dev, 13, nans=True)
    out, slots = gather.graph_max_pool_src_cuda(x, idx)
    want, want_slots = ops.graph_max_pool_slots_strict(x, idx)
    assert torch.isnan(want).any() and _bits_equal(out, want) and torch.equal(slots, want_slots)
    x, idx = _pool_case(2, 2048, f, 25, dev, 14, nans=False)
    out, slots = gather.graph_max_pool_src_cuda(x, idx)
    want, want_slots = ops.graph_max_pool_slots(x, idx)
    assert torch.equal(out, want) and torch.equal(slots, want_slots)
    assert torch.equal(out, gather.graph_max_pool_cuda(x, idx))
    g = _randn((2, 2048, f), 15, dev)
    got = gather.scatter_add_slots_cuda(g, idx, slots, 2048)
    assert torch.equal(got.cpu(), ops.scatter_add_slots(g.cpu(), idx.cpu(), slots.cpu(), 2048))
    assert torch.equal(got, gather.scatter_add_slots_cuda(g, idx, slots, 2048))


@pytest.mark.parametrize('m,n', [(2048, 2048), (300, 2048), (2048, 100), (1000, 3073)])
@pytest.mark.parametrize('width,ranges', [(None, None), (16, 2), (8, 1), (4, 4), (16, 8)])
def test_slot_scatter_adds_in_centre_order(dev, m, n, width, ranges):
    """Terms whose sum depends on the order of adds (1e8, 1, -1e8, 1 into one
    row: 1 in ascending centre order), within one batch of 32 centres and
    across batches and chunks of 256, and a hub row: every slice width and
    row split bit-equal to the plain version on the CPU."""
    f, k = 64, 25
    g = _randn((2, m, f), 50 + m, dev)
    idx = _graph(2, m, k, dev, 51 + m) % n
    slots = torch.randint(0, k, (2, m, f), generator=torch.Generator().manual_seed(52), dtype=torch.uint8).to(dev)
    idx[:, : m // 2, 3] = 7  # a hub row
    for centres, row in (((0, 1, 2, 3), 5 % n), ((31, 32, 255, 256), 9 % n)):
        for i, v in zip((c % m for c in centres), (1e8, 1.0, -1e8, 1.0)):
            idx[:, i, 0], slots[:, i], g[:, i] = row, 0, v
    got = gather.scatter_add_slots_cuda(g, idx, slots, n, slice_width=width, ranges=ranges)
    want = ops.scatter_add_slots(g.cpu(), idx.cpu(), slots.cpu(), n)
    assert torch.equal(got.cpu(), want)


def test_slot_scatter_plan_is_the_kernels(dev):
    """``gather.slot_scatter_plan`` mirrors the plan the kernel library takes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (100, 2048, 2593, 6217, 13465, gather.MAX_SLOT_SCATTER_ROWS):
        for b in (1, 2, 8, 16, 32):
            for f in (4, 12, 48, 64, 128, 256):
                for width, ranges in ((None, None), *((w, None) for w in gather.SLICE_WIDTHS), (None, 2), (8, 3),
                                      (4, 8), (16, 9)):
                    try:
                        want = gather.slot_scatter_plan(b, n, f, width, ranges, sms)
                    except ValueError:
                        with pytest.raises(ValueError, match='does not cover'):
                            gather.kernel_slot_scatter_plan(b, n, f, width, ranges)
                        continue
                    assert gather.kernel_slot_scatter_plan(b, n, f, width, ranges) == want, (b, n, f, width, ranges)


def test_sum_pool_matches_plain(dev):
    x = _randn((2, 2048, 256), 16, dev)
    idx = _graph(2, 2048, 25, dev, 17)
    assert _max_rel(gather.graph_sum_pool_cuda(x, idx), ops.graph_sum_pool(x, idx)) <= 1e-5


def _bits_equal(a, b):
    """Equal bit for bit where neither is NaN, and NaN at the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _pool_case(b, n, c, k, dev, seed, nans):
    """Exact ties (row 40 a copy of row 7, both in every list), a hub row in
    3/4 of the lists and, for the max, NaNs in two rows."""
    x = _randn((b, n, c), seed, dev)
    x[:, 40] = x[:, 7]
    idx = _graph(b, n, k, dev, seed + 1)
    idx[..., 1], idx[..., k - 1] = 7, 40
    idx[:, : 3 * n // 4, k // 2] = 11
    if nans:
        x[:, 11, ::3] = float('nan')
        x[:, 12, 1::5] = float('nan')
        idx[:, ::7, 0] = 12
    return x, idx


@pytest.mark.parametrize('width', [None, 16, 8, 4])
@pytest.mark.parametrize('k', [20, 25])
@pytest.mark.parametrize('b,c', [(1, 64), (16, 256), (32, 256)])
def test_slice_pools_at_every_width(dev, b, c, k, width):
    """Every slice width the plan can choose: the max bit-exact to the plain
    version with NaNs, ties and a hub row; the sum bit-equal to the sum in slot
    order on the CPU, and the same on a second call."""
    x, idx = _pool_case(b, 2048, c, k, dev, 40 + b + k, nans=True)
    got = gather.graph_max_pool_cuda(x, idx, slice_width=width)
    assert torch.isnan(got).any() and _bits_equal(got, ops.graph_max_pool(x, idx))
    x, idx = _pool_case(b, 2048, c, k, dev, 41 + b + k, nans=False)
    got = gather.graph_sum_pool_cuda(x, idx, slice_width=width)
    assert torch.equal(got.cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx.cpu()))
    assert torch.equal(got, gather.graph_sum_pool_cuda(x, idx, slice_width=width))


@pytest.mark.parametrize('b,n,c,width', [(b, n, c, w) for b, n, c in ((2, 300, 48), (3, 1000, 64), (100, 3073, 16))
                                         for w in (None, 16, 8, 4)])
def test_slice_pools_with_a_tail_box(dev, b, n, c, width):
    """Clouds that end in a box shorter than 256 rows: one box alone at N =
    300, a last box of one row at N = 3073."""
    x, idx = _pool_case(b, n, c, 20, dev, 46 + n, nans=True)
    assert _bits_equal(gather.graph_max_pool_cuda(x, idx, slice_width=width), ops.graph_max_pool(x, idx))
    x, idx = _pool_case(b, n, c, 20, dev, 47 + n, nans=False)
    got = gather.graph_sum_pool_cuda(x, idx, slice_width=width)
    assert torch.equal(got.cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx.cpu()))


@pytest.mark.parametrize('n', [2048, 300, 3104, 13951])
def test_slice_pool_plan_is_the_kernels(dev, n):
    """``gather.pool_plan`` mirrors the plan the kernel library takes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (1, 2, 5, 8, 16, 32):
        for c in (4, 12, 48, 64, 128, 256, 512):
            for width in (None, *gather.SLICE_WIDTHS):
                try:
                    want = gather.pool_plan(b, n, c, width, sms)
                except ValueError:
                    with pytest.raises(ValueError, match='does not cover'):
                        gather.kernel_pool_plan(b, n, c, width)
                    continue
                assert gather.kernel_pool_plan(b, n, c, width) == want, (b, n, c, width)


def test_slice_pools_at_the_row_limit(dev):
    """N = 13951 points fill the shared memory in 4-channel slices (a tail
    box of 127 rows); one more point raises ``ValueError`` before any launch."""
    n = gather.MAX_POOL_ROWS
    x, idx = _pool_case(1, n, 8, 25, dev, 42, nans=True)
    assert _bits_equal(gather.graph_max_pool_cuda(x, idx), ops.graph_max_pool(x, idx))
    x, idx = _pool_case(1, n, 8, 25, dev, 43, nans=False)
    assert torch.equal(gather.graph_sum_pool_cuda(x, idx).cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx.cpu()))
    api.reset_launch_counts()
    x = _randn((1, n + 1, 8), 44, dev)
    idx = _graph(1, n + 1, 4, dev, 45)
    for call in (gather.graph_max_pool_cuda, gather.graph_sum_pool_cuda):
        with pytest.raises(ValueError, match='N <= 13951'):
            call(x, idx)
    with pytest.raises(ValueError, match='does not cover'):
        gather.graph_max_pool_cuda(x[:, :n].contiguous(), idx[:, :n].contiguous(), slice_width=16)
    assert api.launch_counts()['graph_max_pool'] == api.launch_counts()['graph_sum_pool'] == 0


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
                 'scatter_add_rows', 'emd_forward', 'nn_distance', 'graph_filtering_with_idx'):
        monkeypatch.setattr(ops, name, boom)
    for name in ('plain', 'plain_backward'):
        monkeypatch.setattr(graph_filter, name, boom)
    api.reset_launch_counts()
    x = _randn((2, 512, 64), 20, dev).requires_grad_(True)
    idx = api.knn(x, 8)
    y = api.graph_max_pool(x, idx).sum() + api.graph_sum_pool(x, idx).sum()
    cloud = _randn((2, 512, 3), 21, dev).requires_grad_(True)
    cham, cost = api.chamfer_match_cost(api.graph_filtering(cloud), _randn((2, 512, 3), 22, dev))
    (y + cham.sum() + cost.sum() + api.match_cost(cloud, _randn((2, 512, 3), 23, dev)).sum()).backward()
    torch.cuda.synchronize()
    counts = api.launch_counts()
    for name in ('graph_filter', 'graph_filter_backward', 'scatter_add_rows', 'graph_max_pool_src',
                 'scatter_add_slots', 'graph_sum_pool'):
        assert counts[name] >= 1, name
    assert counts['chamfer_match_cost'] == 2 and counts['graph_max_pool'] == 0
    assert counts['gather_neighbors'] == 0 and counts['knn'] == 1  # graph filtering runs neither
    assert bool(torch.isfinite(x.grad).all()) and bool(torch.isfinite(cloud.grad).all())


def test_new_wrappers_refuse_shapes_they_do_not_cover(dev):
    x = _randn((1, 64, 6), 24, dev)
    idx = _graph(1, 64, 4, dev, 25)
    # F % 4 is covered now: the wrappers pad the channels to four and crop
    out, slots6 = gather.graph_max_pool_src_cuda(x, idx)
    assert out.shape == x.shape and torch.equal((out, slots6)[0], ops.graph_max_pool_slots_strict(x, idx)[0])
    assert torch.equal(gather.graph_sum_pool_cuda(x, idx).cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx.cpu()))
    with pytest.raises(ValueError, match='does not cover'):  # slots are uint8
        gather.graph_max_pool_src_cuda(_randn((1, 300, 8), 26, dev), _graph(1, 300, 256, dev, 27))
    with pytest.raises(ValueError):
        gather.gather_neighbors_cuda(x, idx.long())
    with pytest.raises(ValueError):
        emd.chamfer_match_cost_cuda(x, x)  # not 3-D points
    with pytest.raises(ValueError, match='does not cover'):  # rows past the transposed graph's 65536
        gather.scatter_add_rows_cuda(x, idx, 70000)
    # clouds past the slot pool's and the slot scatter's N limits, refused before any launch
    api.reset_launch_counts()
    n = gather.MAX_POOL_ROWS + 1
    with pytest.raises(ValueError, match='N <= 13951'):
        gather.graph_max_pool_src_cuda(_randn((1, n, 8), 28, dev), _graph(1, n, 4, dev, 29))
    g, gidx = _randn((1, 64, 8), 30, dev), _graph(1, 64, 4, dev, 31)
    slots = torch.zeros((1, 64, 8), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match=f'N <= {gather.MAX_SLOT_SCATTER_ROWS}'):
        gather.scatter_add_slots_cuda(g, gidx, slots, gather.MAX_SLOT_SCATTER_ROWS + 1)
    with pytest.raises(ValueError, match='does not cover'):  # 9 row ranges, one past the plan's limit
        gather.scatter_add_slots_cuda(g, gidx, slots, 64, slice_width=4, ranges=9)
    assert api.launch_counts()['graph_max_pool_src'] == api.launch_counts()['scatter_add_slots'] == 0
    got = gather.scatter_add_slots_cuda(x, idx, slots6, 64)  # F % 4, padded
    assert torch.equal(got.cpu(), ops.scatter_add_slots(x.cpu(), idx.cpu(), slots6.cpu(), 64))


# ------------------------------------------------ graph filtering's fused pass

FILTER_REL_MAX = 1e-5  # expf's ulp and the per-cloud mean summed in another order than the plain version's
FILTER_GRAD_REL_L2 = 1e-5  # the same through the backward's rows, then the row scatter (ascending edge order)


def _filter_cloud(b, n, seed, dev, duplicates=False):
    x = _randn((b, n, 3), seed, dev) * 0.5
    if duplicates:  # every point twice, and in cloud 0 point 8 three times (101 then alone)
        x[:, 1::2] = x[:, 0::2]
        x[0, 100] = x[0, 8]
    return x


@pytest.mark.parametrize('b,n,duplicates', [(1, 2048, False), (5, 2048, False), (8, 2048, False), (16, 2048, False),
                                            (8, 2048, True), (2, 512, False), (3, 300, False), (1, 5000, False)])
def test_graph_filter_matches_plain(dev, b, n, duplicates):
    """The indices are knn_cuda(x, 4)'s index for index (and the plain kNN's
    up to near-ties); the output and the mean are the plain version's on those
    indices; a second call gives the same bits."""
    x = _filter_cloud(b, n, 40 + b, dev, duplicates)
    out, idx, mean = graph_filter.graph_filter_cuda(x)
    assert torch.equal(idx, knn.knn_cuda(x, 4))
    assert _knn_agrees(x, idx, knn.plain(x, 4), 4)
    if duplicates:
        # slot 0 holds the lowest index among each point's exact copies
        lowest = (x[:, :, None, :] == x[:, None, :, :]).all(-1).int().argmax(-1)
        assert torch.equal(idx[..., 0].long(), lowest) and idx[0, [8, 9, 100], 0].tolist() == [8, 8, 8]
    neigh = ops.gather_neighbors(x, idx)[:, :, 1:, :]
    dist = torch.sqrt(torch.abs(((x[:, :, None, :] - neigh) ** 2).sum(-1)) + 1e-12)
    assert _max_rel(out, ops.graph_filtering_with_idx(x, idx)) <= FILTER_REL_MAX
    assert _max_rel(mean, dist[:, :, 0].mean(1)) <= FILTER_REL_MAX
    again = graph_filter.graph_filter_cuda(x)  # fixed-order sums: the same bits on every call
    assert all(torch.equal(a, c) for a, c in zip((out, idx, mean), again))


@pytest.mark.parametrize('b', [1, 8, 16])
def test_graph_filter_nan_cloud(dev, b):
    """Graph filtering with one NaN point in one cloud: its indices are the
    plain kNN's and ``knn_cuda(x, 4)``'s index for index (integer
    coordinates), the NaN cloud's output and mean NaN as the plain version's,
    the other clouds' lists as without it and their output within the
    filter's tolerance of it (the mean's partials may add in another order)."""
    x = _nan_grid(b, 2048, 3, 90 + b, dev, cloud=b - 1, points=(5, 1500))
    out, idx, mean = graph_filter.graph_filter_cuda(x)
    assert torch.equal(idx, knn.knn_cuda(x, 4)) and torch.equal(idx.cpu(), knn.plain(x.cpu(), 4))
    assert idx[b - 1, 5].tolist() == [0, 1, 2, 3]
    want = ops.graph_filtering_with_idx(x, idx)
    assert bool(torch.isnan(out[b - 1]).all()) and bool(torch.isnan(want[b - 1]).all()) and bool(mean[b - 1].isnan())
    if b > 1:
        assert _max_rel(out[:-1], want[:-1]) <= FILTER_REL_MAX
        alone = graph_filter.graph_filter_cuda(x[:-1].contiguous())
        assert torch.equal(idx[:-1], alone[1])
        assert _max_rel(out[:-1], alone[0]) <= FILTER_REL_MAX and _max_rel(mean[:-1], alone[2]) <= FILTER_REL_MAX


@pytest.mark.parametrize('b,n,scale', [(8, 2048, 0.5), (8, 2048, 0.002), (2, 512, 0.5), (3, 300, 0.5)])
def test_graph_filter_backward_matches_plain(dev, b, n, scale):
    """dx against the closed-form plain backward on the card and on the CPU
    (scale 0.002: the 0.005 clamp active); one backward kernel call and one
    row scatter; a second call gives the same bits.  The plain row scatter
    adds in ascending edge order on both devices: on the card it once summed
    with ``index_add_``'s atomics, whose order differs run to run (at
    (8, 2048, 0.5) 50 distinct results over 50 runs, 4.4e-8 apart at most,
    on an H100), and this case once read 2.68e-5 against its bound."""
    x = _randn((b, n, 3), 50 + b, dev) * scale
    g = _randn((b, n, 3), 51 + b, dev)
    _, idx, mean = graph_filter.graph_filter_cuda(x)
    assert bool((mean < 0.005).all()) == (scale < 0.01)
    api.reset_launch_counts()
    dx = graph_filter.graph_filter_backward_cuda(x, idx, mean, g)
    counts = api.launch_counts()
    assert counts['graph_filter_backward'] == counts['scatter_add_rows'] == 1 and sum(counts.values()) == 2
    assert _rel_l2(dx, graph_filter.plain_backward(x, idx, mean, g)) <= FILTER_GRAD_REL_L2
    cpu = graph_filter.plain_backward(x.cpu(), idx.cpu(), mean.cpu(), g.cpu())
    assert _rel_l2(dx.cpu(), cpu) <= FILTER_GRAD_REL_L2
    assert torch.equal(dx, graph_filter.graph_filter_backward_cuda(x, idx, mean, g))


def test_graph_filtering_trains_through_the_fused_pass(dev):
    """api.graph_filtering on a CUDA tensor that needs a gradient: the fused
    forward, its backward and the row scatter, no kNN and no gather; value
    and gradient against the same function on the CPU."""
    x = _filter_cloud(2, 512, 52, 'cpu')
    g = _randn((2, 512, 3), 53, 'cpu')
    api.reset_launch_counts()
    xc = x.to(dev).requires_grad_(True)
    out = api.graph_filtering(xc)
    out.backward(g.to(dev))
    torch.cuda.synchronize()
    counts = api.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {'graph_filter': 1, 'graph_filter_backward': 1,
                                                      'scatter_add_rows': 1}
    xr = x.clone().requires_grad_(True)
    want = api.graph_filtering(xr)
    want.backward(g)
    assert _max_rel(out.detach().cpu(), want.detach()) <= FILTER_REL_MAX
    assert _rel_l2(xc.grad.cpu(), xr.grad) <= FILTER_GRAD_REL_L2


def test_graph_filter_refuses_shapes_it_does_not_cover(dev):
    """Past the guard (N < 4, N > 65536, C != 3) both wrappers raise
    ValueError before any launch."""
    api.reset_launch_counts()
    for shape in ((1, 3, 3), (1, graph_filter.MAX_POINTS + 1, 3), (1, 64, 4), (2, 64, 2)):
        x = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError, match='does not cover'):
            graph_filter.graph_filter_cuda(x)
        idx = torch.zeros((*shape[:2], 4), dtype=torch.int32, device=dev)
        mean = torch.zeros(shape[0], device=dev)
        with pytest.raises(ValueError, match='does not cover'):
            graph_filter.graph_filter_backward_cuda(x, idx, mean, torch.zeros_like(x))
    with pytest.raises(ValueError):
        graph_filter.graph_filter_cuda(torch.zeros((1, 64, 3), device=dev, dtype=torch.float64))
    assert set(api.launch_counts().values()) == {0}


@pytest.mark.parametrize('b,n', [(1, 2048), (5, 2048), (8, 2048), (16, 2048), (2, 512), (3, 300), (1, 65536)])
def test_graph_filter_plan_is_the_kernels(dev, b, n):
    for sms in (132, 114, torch.cuda.get_device_properties(dev).multi_processor_count):
        assert graph_filter.filter_plan(b, n, sms) == graph_filter.kernel_filter_plan(b, n, sms)


def _clouds(n, m, seed, dev, b=2):
    x = _randn((b, n, 3), seed, dev) * 0.5
    y = _randn((b, m, 3), seed + 1, dev) * 0.5
    y[:, 5] = y[:, 1]  # exact ties: the lowest index wins
    x[:, 9] = x[:, 2]
    return x, y


@pytest.mark.parametrize('n,m,many_ties', [(2048, 2048, False), (2048, 1024, False), (300, 77, False),
                                           (512, 512, True), (2048, 2048, True)])
def test_nn_distance_matches_plain_exactly(dev, n, m, many_ties):
    x, y = _clouds(n, m, 30, dev)
    if many_ties:  # a hub most of x is nearest to, and every point twice on both sides
        y[:, 100] = 0.0
        x[:, ::4] *= 0.01
        x[:, 1::2] = x[:, 0::2]
        y[:, 1::2] = y[:, 0::2]
    got, want = chamfer.nn_distance_cuda(x, y), chamfer.plain(x, y)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool((got[1] == 5).any()) and not bool((got[3] == 9).any())
    if many_ties:
        assert not bool((got[1] % 2 == 1).any()) and not bool((got[3] % 2 == 1).any())
    again = chamfer.nn_distance_cuda(x, y)  # no atomics: the same bits on every call
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize('b,n,splits', [(8, 2048, 1), (2, 2048, 2), (1, 2048, 4), (1, 1024, 8), (1, 512, 16)])
def test_nn_distance_every_split_is_exact(dev, b, n, splits):
    """Each column split chamfer.nn_plan takes on a 132-SM card, against 700
    columns (no multiple of a split's range)."""
    assert chamfer.nn_plan(b, n, 132) == splits
    x, y = _clouds(n, 700, 37, dev, b)
    want = chamfer.plain(x, y)
    assert all(torch.equal(a, b) for a, b in zip(chamfer.nn_distance_cuda(x, y), want))


@pytest.mark.parametrize('b,n,m', [(2, 1024, 1024), (2, 1024, 512), (2, 300, 77), (8, 2048, 2048)])
def test_sinkhorn_cost_matches_plain(dev, b, n, m):
    x, y = _clouds(n, m, 31, dev, b)
    got, want = sinkhorn.sinkhorn_cost_cuda(x, y), sinkhorn.plain(x, y)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
    assert _rel_l2(got[1], want[1]) <= 1e-3 and _rel_l2(got[2], want[2]) <= 1e-3
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a, b)
    again = sinkhorn.sinkhorn_cost_cuda(x, y)  # no atomics: the same bits on every call
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the device kernel of each sweep of sinkhorn.schedule(): its mode and side
SWEEP_KERNELS = {('rows', 'build'): 'sinkhorn_build_kernel',
                 ('cols', 'chamfer'): 'sinkhorn_sweep_kernel<0, false',
                 ('rows', 'middle'): 'sinkhorn_sweep_kernel<1, true',
                 ('cols', 'middle'): 'sinkhorn_sweep_kernel<1, false',
                 ('cols', 'final'): 'sinkhorn_sweep_kernel<2, false',
                 ('rows', 'final'): 'sinkhorn_sweep_kernel<2, true'}


@pytest.mark.parametrize('n,m', [(2048, 2048), (2048, 1024)])
def test_sinkhorn_launches_its_schedule(dev, n, m, monkeypatch):
    """One call's device launches, from a torch.profiler trace: the 25 sweeps
    of sinkhorn.schedule() in order, then the per-sample sum.  CUPTI stays up
    between sessions (a session after Kineto's teardown can miss launches:
    tools/torch_profiler_sessions.py)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv('TEARDOWN_CUPTI', '0')

    x, y = _clouds(n, m, 38, dev, 8)
    sinkhorn.sinkhorn_cost_cuda(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sinkhorn.sinkhorn_cost_cuda(x, y)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    want = [SWEEP_KERNELS[sweep] for sweep in sinkhorn.schedule()] + ['sample_sum_kernel']
    assert len(names) == len(want) == 26
    for name, kernel in zip(names, want):
        assert kernel in name, (name, kernel)


@pytest.mark.parametrize('b,n,m', [(8, 2048, 2048), (8, 2048, 1024), (2, 512, 512), (2, 300, 77), (1, 33, 4100)])
def test_sinkhorn_sweep_plan_is_the_kernels(dev, b, n, m):
    for sms in (132, 114, torch.cuda.get_device_properties(dev).multi_processor_count):
        assert sinkhorn.sweep_plan(b, n, m, sms) == sinkhorn.kernel_sweep_plan(b, n, m, sms)


def _loss_grads(fn, x, y):
    xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = fn(xs, ys)
    out = out if isinstance(out, tuple) else (out,)
    sum((i + 1.0) * (o * torch.linspace(0.5, 1.5, o.shape[0], device=o.device)).sum()
        for i, o in enumerate(out)).backward()
    return [o.detach().cpu() for o in out], xs.grad.cpu(), ys.grad.cpu()


@pytest.mark.parametrize('loss', ['chamfer', 'chamfer_sinkhorn'])
def test_loss_gradients_on_cuda_match_cpu(dev, loss):
    """The loss kernel once, and the row scatter twice for the Chamfer
    term's backward (one a direction, in a fixed order); values and
    gradients against the CPU."""
    fn = {'chamfer': api.chamfer, 'chamfer_sinkhorn': api.chamfer_sinkhorn_cost}[loss]
    x, y = _clouds(512, 384, 32, 'cpu')
    api.reset_launch_counts()
    got = _loss_grads(fn, x.to(dev), y.to(dev))
    counts = api.launch_counts()
    want = _loss_grads(fn, x, y)
    assert counts['sinkhorn_cost' if 'sinkhorn' in loss else 'nn_distance'] == 1
    assert counts['scatter_add_rows'] == 2 and sum(counts.values()) == 3
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


@pytest.mark.parametrize('k', [32, 512, 1024])
@pytest.mark.parametrize('n', [64, 512, 1024])
@pytest.mark.parametrize('m', [64, 4096, 8192])
def test_gemm_bf16_weights_match_float64(dev, m, n, k):
    """``pccf_gemm_bf16w`` over every tile shape: float32 arithmetic on
    bf16 weights widened exactly, two TF32 products, against float64 on the
    widened weights; the f32 instance's bound."""
    a, (wt,), (bias,), stacks = _gemm_case(m, n, k, 1, m + n + k + 1, dev)
    wt = wt.to(torch.bfloat16)
    out = torch.empty(m, n, device=dev)
    before = wformer.gemm_bf16w_cuda.launches
    stacks.gemm(a, [wt], [bias], [out])
    assert wformer.gemm_bf16w_cuda.launches == before + 1
    assert _rel_l2(out.double(), wformer.gemm_plain(a.double(), wt, bias.double())) <= 5e-6


@pytest.mark.parametrize('epilogue', ['gelu', 'alias', 'grouped'])
def test_gemm_bf16_weights_epilogues_match_float64(dev, epilogue):
    m, n, k = 4096, 512, 512
    groups = 3 if epilogue == 'grouped' else 1
    a, wts, biases, stacks = _gemm_case(m, n, k, groups, 90, dev)
    wts = [w.to(torch.bfloat16) for w in wts]
    outs = [torch.empty(m, n, device=dev) for _ in wts]
    if epilogue == 'alias':
        res = _randn((m, n), 91, dev)
        want = [wformer.gemm_plain(a.double(), wts[0], None, res.double())]
        outs = [res]
        stacks.gemm(a, wts, [None], outs, res)
    else:
        stacks.gemm(a, wts, biases, outs, gelu=epilogue == 'gelu')
        want = [wformer.gemm_plain(a.double(), w, b.double(), gelu=epilogue == 'gelu') for w, b in zip(wts, biases)]
    for got, ref in zip(outs, want):
        assert _rel_l2(got.double(), ref) <= 5e-6


@pytest.mark.parametrize('epilogue', ['bias', 'gelu', 'alias', 'grouped'])
@pytest.mark.parametrize('k', [32, 96, 512, 1024])
@pytest.mark.parametrize('m,n', [(64, 512), (4096, 512), (8192, 512)])
def test_gemm_bf16_weights_every_tile_and_k(dev, m, n, k, epilogue):
    """``pccf_gemm_bf16w`` at each tile it takes (64x64, 128x64 and 128x128
    at N = 512), K of one, three (an odd count: the last tile has no next
    to prefetch), 16 and 32 k tiles, with each epilogue, against float64 on
    the widened weights; one launch a call, and the tile the library took
    is the mirror's."""
    groups = 3 if epilogue == 'grouped' else 1
    a, wts, biases, stacks = _gemm_case(m, n, k, groups, 7 * m + n + k, dev)
    wts = [w.to(torch.bfloat16) for w in wts]
    outs = [torch.empty(m, n, device=dev) for _ in wts]
    before = wformer.gemm_bf16w_cuda.launches
    if epilogue == 'alias':
        res = _randn((m, n), 92, dev)
        want = [wformer.gemm_plain(a.double(), wts[0], None, res.double())]
        outs = [res]
        stacks.gemm(a, wts, [None], outs, res)
    else:
        stacks.gemm(a, wts, biases, outs, gelu=epilogue == 'gelu')
        want = [wformer.gemm_plain(a.double(), w, b.double(), gelu=epilogue == 'gelu') for w, b in zip(wts, biases)]
    assert wformer.gemm_bf16w_cuda.launches == before + 1
    for got, ref in zip(outs, want):
        assert _rel_l2(got.double(), ref) <= 5e-6
    assert wformer.kernel_gemm_plan(m, n, groups, True) == wformer.gemm_plan(m, n, groups, True)


@pytest.mark.parametrize('bf16', [False, True])
def test_gemm_plan_is_the_kernels(dev, bf16):
    """``wformer.gemm_plan`` mirrors the tile, ring and shared memory the
    library takes, and fits the card."""
    for m in (64, 128, 256, 4096, 8192):
        for n in (64, 128, 512, 1024):
            for groups in (1, 2, 3):
                plan = wformer.gemm_plan(m, n, groups, bf16)
                assert wformer.kernel_gemm_plan(m, n, groups, bf16) == plan, (m, n, groups)
                assert plan.smem <= wformer.MAX_SMEM


def test_wide_attention_plan_is_the_kernels(dev):
    for t_k in (64, 128, 256, 384, 640):
        for hd in (129, 130, 136, 192, 256, 320, 512, 1024):
            assert wformer.kernel_wide_plan(t_k, hd) == wformer.wide_plan(t_k, hd), (t_k, hd)
    with pytest.raises(ValueError, match='does not cover'):
        wformer.kernel_wide_plan(256, 128)


def _wide_want(q, k, v, b, heads, hd):
    def split(x):
        return x.double().reshape(b, -1, heads, hd).transpose(1, 2)

    w = torch.softmax(split(q) @ split(k).transpose(-1, -2) / hd ** 0.5, dim=-1)
    return (w @ split(v)).transpose(1, 2).reshape(-1, heads * hd)


@pytest.mark.parametrize('t_q,t_k', [(256, 256), (128, 384), (64, 640)])
@pytest.mark.parametrize('hd,heads', [(192, 2), (256, 2), (320, 1), (512, 1), (136, 2), (130, 2)])
def test_wide_attention_matches_float64(dev, hd, heads, t_q, t_k):
    """The wide instance alone against the exact softmax in float64: heads
    of 192, 256, 320 and 512, and of 136 and 130 (a last 32-column chunk
    partly past the head); self-attention at 256 keys (one score tile),
    cross-attention of 128 queries against 384 keys and of 64 against 640
    (score tiles of 256, 256 and 128, the softmax running on across them);
    q from a (rows, 3d) buffer and k, v from a (rows, 2d) one at their row
    strides; one launch a call, counted apart."""
    b, d = 2, heads * hd
    qbuf, kvbuf = _randn((b * t_q, 3 * d), hd + t_q, dev), _randn((b * t_k, 2 * d), hd + t_k + 1, dev)
    q, k, v = qbuf[:, d: 2 * d], kvbuf[:, :d], kvbuf[:, d:]
    out = torch.empty(b * t_q, d, device=dev)
    before = wformer.attention_wide_cuda.launches
    wformer.Stacks(b, t_q, d, dev).attend(q, k, v, out, heads)
    assert wformer.attention_wide_cuda.launches == before + 1
    assert _rel_l2(out.double(), _wide_want(q, k, v, b, heads, hd)) <= 1e-5


def test_wide_attention_slices_of_one_buffer(dev):
    """q, k and v as column slices of one (rows, 3d) projection buffer (the
    grouped q, k, v launch), two heads of 256, written into a column slice
    of a wider output; the columns around it untouched."""
    b, t, heads, hd = 3, 128, 2, 256
    d = heads * hd
    qkv = _randn((b * t, 3 * d), 5, dev)
    q, k, v = qkv[:, :d], qkv[:, d: 2 * d], qkv[:, 2 * d:]
    wide_out = torch.full((b * t, d + 64), 7.0, device=dev)
    wformer.Stacks(b, t, d, dev).attend(q, k, v, wide_out[:, 32: 32 + d], heads)
    assert _rel_l2(wide_out[:, 32: 32 + d].double(), _wide_want(q, k, v, b, heads, hd)) <= 1e-5
    assert bool((wide_out[:, :32] == 7.0).all()) and bool((wide_out[:, 32 + d:] == 7.0).all())


def test_wide_attention_refuses_views_off_16_bytes(dev):
    """The wide instance reads q, k and v by TMA: a view that does not start
    on 16 bytes is refused, not read."""
    b, t, heads, hd = 1, 64, 1, 256
    buf = _randn((b * t, hd + 4), 6, dev)
    q = buf[:, 1: 1 + hd]
    with pytest.raises(ValueError, match='does not cover'):
        wformer.Stacks(b, t, hd, dev).attend(q, buf[:, :hd], buf[:, :hd], torch.empty(b * t, hd, device=dev), heads)


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


# ---- the evaluation suites' and the classifier step's shapes --------------
# The derived datasets run the VQ-VAE in chunks of 64 clouds: 186 test clouds
# give chunks of 64, 64 and 58, a subset of one cloud a chunk of 1.  The
# classifier trains at batch 16 with k = 20 and EdgeConv widths 64/64/128/256.

SUITE_BATCHES = (64, 58, 1)


@pytest.mark.parametrize('c', [3, 64, 128])
@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_knn_at_the_suites_chunks(dev, b, c):
    x = _randn((b, 2048, c), 80 + b + c, dev)
    got = knn.knn_cuda(x, 25)
    assert _knn_agrees(x, got, knn.plain(x, 25), 25)
    assert torch.equal(got[..., 0].long(), torch.arange(2048, device=dev).expand(b, -1))


@pytest.mark.parametrize('f', [64, 128, 256])
@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_graph_max_pool_at_the_suites_chunks(dev, b, f):
    x, idx = _pool_case(b, 2048, f, 25, dev, 90 + b + f, nans=False)
    assert torch.equal(gather.graph_max_pool_cuda(x, idx), ops.graph_max_pool(x, idx))


@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_pcgen_mix_at_the_suites_chunks(dev, b):
    pack = _pcgen_pack(dev, g=8, dims=(1024, 1024, 256, 16), dm=64)
    m, w = torch.relu(_randn((b, 2048, 64), 100 + b, dev)), _randn((b, 1024), 101 + b, dev)
    got = pcgen.pcgen_mix_cuda(m, w, pack, tau=5.0, act_slope=0.0)
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)) <= PCGEN_REL_L2


# the fp16 operands' scales are exact, so a decode past fp16's range keeps the
# precision of one inside it; RECON_REL_L2, the bound every decode on the card
# is held to, is what the check allows
RECON_REL_L2 = 1e-2


@pytest.mark.parametrize('past', ['layer 0', 'latent'])
def test_pcgen_mix_keeps_fp32_range_past_fp16(dev, past):
    """Component weights inside 65504 whose layer-0 output passes it (and,
    the other case, a latent past it): the kernel keeps fp32's range (a
    power-of-two scale per cloud on each fp16 operand) and agrees with the
    plain version, which is finite.  The mix weights shrink by the same
    factor, so that the tempered softmax sees logits of the usual size and
    the check reads the range, not the softmax's gain on the fp16 rounding."""
    pack = _pcgen_pack(dev, g=8, dims=(1024, 1024, 256, 16), dm=64)
    m, w = torch.relu(_randn((2, 2048, 64), 110, dev)), _randn((2, 1024), 111, dev)
    factor = 2e4 if past == 'layer 0' else 1e5
    if past == 'layer 0':
        pack.layer_ws = (pack.layer_ws[0] * factor, *pack.layer_ws[1:])
    else:
        w = w * factor
    pack.att_w = pack.att_w / factor
    assert float(pack.layer_ws[0].abs().max()) <= pcgen.FP16_MAX
    x = w[:, None, :] * torch.clamp(m @ pack.map_w.T + pack.map_b, -1.0, 1.0)
    h0 = torch.relu(torch.einsum('bnd,gfd->gbnf', x, pack.layer_ws[0]) + pack.layer_bs[0][:, None, None, :])
    assert float(h0.abs().max()) > pcgen.FP16_MAX
    want = pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)
    got = pcgen.pcgen_mix_cuda(m, w, pack, tau=5.0, act_slope=0.0)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert _rel_l2(got, want) <= RECON_REL_L2


@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_cvae_chain_at_the_suites_chunks(dev, b):
    """The flagship's token count (256) and the chunks' batches."""
    pack = _cvae_pack(dev, 256)
    x = _randn((b, 256, 4), 120 + b, dev)
    probs = torch.softmax(_randn((b, 2), 121 + b, dev), -1)
    assert _rel_l2(cvae.cvae_cf_cuda(x, probs, pack), ops.cvae_cf(x, probs, pack)) <= 1e-4


@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_graph_filter_at_the_suites_chunks(dev, b):
    x = _filter_cloud(b, 2048, 130 + b, dev)
    out, idx, mean = graph_filter.graph_filter_cuda(x)
    assert torch.equal(idx, knn.knn_cuda(x, 4))
    assert _max_rel(out, ops.graph_filtering_with_idx(x, idx)) <= FILTER_REL_MAX


@pytest.mark.parametrize('decoder', [False, True])
@pytest.mark.parametrize('b', SUITE_BATCHES)
def test_wformer_stacks_at_the_suites_chunks(dev, b, decoder):
    """The W-nets' stacks in eval at 256 tokens of width 512 (8 heads)."""
    gen = torch.Generator().manual_seed(140 + b)
    pack = [_layer(512, 1024, gen, dev, decoder) for _ in range(2)]
    x, memory = _randn((b, 256, 512), 141 + b, dev), _randn((b, 256, 512), 142 + b, dev)
    if decoder:
        got, want = wformer.wformer_decoder_cuda(x, memory, pack, 8), wformer.plain_decoder(x, memory, pack, 8)
    else:
        got, want = wformer.wformer_encoder_cuda(x, pack, 8), wformer.plain_encoder(x, pack, 8)
    assert _rel_l2(got, want) <= 1e-4


@pytest.mark.parametrize('f', [64, 128, 256])
def test_classifier_step_kernels_at_batch_16(dev, f):
    """The classifier's EdgeConv in training at batch 16 x 2048, k = 20: the
    sum-pool of [u, u^2] and its row scatter, the pool with its slot and its
    slot scatter."""
    b, n, k = 16, 2048, 20
    x, idx = _pool_case(b, n, f, k, dev, 150 + f, nans=False)
    u2 = torch.cat([x, x * x], dim=-1)
    assert _max_rel(gather.graph_sum_pool_cuda(u2, idx), ops.graph_sum_pool(u2, idx)) <= 1e-5
    got = gather.scatter_add_rows_cuda(u2, idx, n)
    assert torch.equal(got.cpu(), ops.scatter_add_rows(u2.cpu(), idx.cpu(), n))
    out, slots = gather.graph_max_pool_src_cuda(x, idx)
    want, want_slots = ops.graph_max_pool_slots(x, idx)
    assert torch.equal(out, want) and torch.equal(slots, want_slots)
    g = _randn((b, n, f), 151 + f, dev)
    got = gather.scatter_add_slots_cuda(g, idx, slots, n)
    assert torch.equal(got.cpu(), ops.scatter_add_slots(g.cpu(), idx.cpu(), slots.cpu(), n))


# ------------------------------------------------ generation and serving


def _small_models():
    """A small VQ-VAE and classifier whose eval paths all pass their gates
    (the configuration of the CPU tests' slice: 256 points, 128 code tokens
    of width 128 with heads of 64, PCGen (512, 512, 64, 16) with 2
    components, graph filtering on), random weights from a seed, on the CPU."""
    from pccf_torch import config as tc
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed

    net = tc.TransformerNetConfig
    cfg = tc.SliceConfig(
        data=tc.DataConfig(n_input_points=256, n_target_points=256, n_neighbors=8, n_classes=2),
        classifier=tc.ClassifierConfig(n_neighbors=6, conv_dims=(8, 16), feature_dim=32, mlp_dims=(32, 16)),
        autoencoder=tc.AutoEncoderConfig(
            book_size=8, embedding_dim=4, w_dim=512,
            decoder=tc.DecoderConfig(sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(512, 64, 16)),
        ),
        w_autoencoder=tc.WAutoEncoderConfig(
            z1_dim=8, z2_dim=6, w_encoder=net(128, 2, (256, 128)), w_decoder=net(128, 2, (128,)),
            conditional_w_encoder=net(128, 2, (256,)),
        ),
    )
    vq, cls = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vq, 0)
    init_from_seed(cls, 1)
    return vq.eval(), cls.eval()


@pytest.fixture(scope='module')
def card_and_cpu_servers(dev):
    """One server on the card and one on the CPU, from the same weights and
    seed: their host draws are the same."""
    import copy

    from pccf_torch.serve import CounterfactualServer

    vq, cls = _small_models()
    card = CounterfactualServer(copy.deepcopy(vq).to(dev), copy.deepcopy(cls).to(dev), buckets=(1, 2, 4), seed=3)
    return card, CounterfactualServer(vq, cls, buckets=(1, 2, 4), seed=3)


def test_async_requests_in_flight_equal_sync(card_and_cpu_servers):
    """Three requests in flight (the last two chunks of 4 and 1) copy into
    pinned host buffers behind events; each result is bit-equal to the
    synchronous request."""
    srv, _ = card_and_cpu_servers
    rng = np.random.default_rng(20)
    reqs = [((rng.standard_normal((m, 256, 3)) / 2).astype(np.float32), np.arange(m) % 2, 10 * m + np.arange(m))
            for m in (1, 3, 5)]
    sync = [srv.counterfactual(c, t, sampling_seed=s) for c, t, s in reqs]
    logits = [srv.classify(c) for c, _, _ in reqs]
    futures = [srv.counterfactual_async(c, t, lg, 1.0, s) for (c, t, s), lg in zip(reqs, logits)]
    assert all(host.is_pinned() and event is not None for f in futures for _, host, event in f._parts)
    assert len(futures[2]._parts) == 2
    for f, want in zip(futures, sync):
        got = f.result()
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize('bias', ['float', 'array'])
def test_generation_on_the_card_matches_the_cpu(card_and_cpu_servers, bias):
    """One generation chunk on the card against the CPU on the same host
    draws: one W-decoder stack, one PCGen and one graph filtering launch and
    nothing else; codes at >= 0.99 agreement, the clouds whose codes all
    agree at rel-L2 1e-2 (the fp16 PCGen kernel); the server's generate
    equal on the card for the same seed."""
    card, cpu = card_and_cpu_servers
    noise, sampling = cpu.generation_draws(4, 7, 0)
    assert all(torch.equal(a, b) for a, b in zip(noise, card.generation_draws(4, 7, 0)[0]))
    z1_bias = 0.5 if bias == 'float' else torch.from_numpy(
        np.random.default_rng(21).standard_normal((4, 128, 8)).astype(np.float32))
    api.reset_launch_counts()
    with torch.inference_mode():
        got = card.vqvae.generate(4, sampling, z1_bias, None, noise)
    counts = api.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {'wformer_decoder': 1, 'pcgen_mix': 1, 'graph_filter': 1}
    with torch.inference_mode():
        want = cpu.vqvae.generate(4, sampling, z1_bias, None, noise)
    same = (got.idx.cpu() == want.idx).all(dim=1)
    assert (got.idx.cpu() == want.idx).float().mean() >= 0.99 and same.any()
    assert _rel_l2(got.recon.cpu()[same], want.recon[same]) <= 1e-2
    a, b = card.generate(3, seed=2), card.generate(3, seed=2)
    assert a.shape == (3, 256, 3) and np.isfinite(a).all() and np.array_equal(a, b)


@pytest.mark.parametrize('b', [1, 16, 64])
def test_wformer_decoder_with_a_one_row_memory(dev, b):
    """The decoder stack on a memory built from one z1 row broadcast over the
    code tokens (the server's generation) and from a row per code
    (``generate.py``'s biased z1), each plus the memory's positional term."""
    gen = torch.Generator().manual_seed(160 + b)
    pack = [_layer(128, f, gen, dev, decoder=True) for f in (256, 128)]
    x, pos = _randn((b, 128, 128), 161 + b, dev), _randn((1, 128, 128), 162, dev)
    for z1_rows in (1, 128):
        memory = (_randn((b, z1_rows, 128), 163 + b, dev).expand(b, 128, 128) + pos).contiguous()
        got, want = wformer.wformer_decoder_cuda(x, memory, pack, 2), wformer.plain_decoder(x, memory, pack, 2)
        assert _rel_l2(got, want) <= 1e-4


# ---------------------------------------------------------------- the widened kernels


def _module_layer(d, heads, f, decoder, seed):
    from pccf_torch.nn.layers import TransformerDecoderLayer, TransformerEncoderLayer, gelu_exact, init_from_seed

    layer = (TransformerDecoderLayer if decoder else TransformerEncoderLayer)(d, heads, f, gelu_exact)
    init_from_seed(layer, seed)
    return layer.eval()


@pytest.mark.parametrize('d,heads,ff', [(128, 16, 137), (256, 8, 1000), (512, 4, 700), (128, 128, 64),
                                        (384, 16, 200), (384, 3, 256), (256, 32, 130), (512, 8, 1024)])
@pytest.mark.parametrize('decoder', [False, True])
def test_stacks_at_every_head_and_ff_width(dev, d, heads, ff, decoder):
    """Heads of 8, 32, 128, 1, 24, 128, 8 and 64 (the flagship's), FF widths
    off the GEMM's 64-column tiles (137, 1000, 700, 200, 130) packed as
    zero-padded copies, against the plain stacks on the same layers; the
    padded copy is made once and kept while the weights do not change."""
    layers = [_module_layer(d, heads, ff, decoder, s) for s in (1, 2)]
    for layer in layers:
        layer.to(dev)
    pack = (wformer.pack_decoder if decoder else wformer.pack_encoder)(layers)
    x, memory = _randn((2, 256, d), 6, dev), _randn((2, 256, d), 7, dev)
    if decoder:
        got, want = wformer.wformer_decoder_cuda(x, memory, pack, heads), wformer.plain_decoder(x, memory, pack, heads)
    else:
        got, want = wformer.wformer_encoder_cuda(x, pack, heads), wformer.plain_encoder(x, pack, heads)
    assert _rel_l2(got, want) <= 1e-4
    again = (wformer.pack_decoder if decoder else wformer.pack_encoder)(layers)
    assert again[0]['w1'].data_ptr() == pack[0]['w1'].data_ptr()  # no new copy
    assert pack[0]['w1'].shape[0] == -(-ff // 64) * 64
    assert (pack[0]['w1'].data_ptr() != layers[0].dense_0.weight.data_ptr()) == (ff % 64 != 0)


@pytest.mark.parametrize('hd', [8, 16, 24, 32, 48, 64, 96, 128, 3])
def test_attention_at_every_head_width(dev, hd):
    """The streaming attention alone, 4 heads of hd (3: the element-by-element
    staging), 384 keys, against the exact softmax in float64."""
    heads, t = 4, 384
    stacks = wformer.Stacks(2, t, heads * hd, dev)
    q, k, v = (_randn((2 * t, heads * hd), s, dev) for s in (1, 2, 3))
    out = torch.empty_like(q)
    stacks.attend(q, k, v, out, heads)

    def split(a):
        return a.double().reshape(2, t, heads, hd).transpose(1, 2)

    w = torch.softmax(split(q) @ split(k).transpose(-1, -2) / hd ** 0.5, dim=-1)
    want = (w @ split(v)).transpose(1, 2).reshape(2 * t, heads * hd)
    assert _rel_l2(out.double(), want) <= 1e-5


@pytest.mark.parametrize('e,heads', [(4, (16, 8, 4)), (40, (4, 4, 4)), (128, (2, 2, 2))])
def test_cvae_chain_at_wide_embeddings_and_heads(dev, e, heads):
    """The chain at embeddings past the old 32 (to 128, JAX's bound) and
    heads of 8, 32 and 64 (d = 128 with 16, 4 and 2 heads) in one chain."""
    pack = _cvae_pack(dev, 128, e=e)
    pack.heads = heads
    x = _randn((3, 128, e), 5, dev)
    probs = torch.softmax(_randn((3, 2), 6, dev), -1)
    got = cvae.cvae_cf_cuda(x, probs, pack)
    assert got.shape == (3, 128, e)
    assert _rel_l2(got, ops.cvae_cf(x, probs, pack)) <= 1e-4


def _general_pack(dev, dims, g, dm):
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    n_layers = len(dims) - 1
    return pcgen.PCGenPack(
        map_w=r(dims[0], dm, scale=dm ** -0.5), map_b=r(dims[0], scale=0.1),
        layer_ws=tuple(r(g, dims[i + 1], dims[i], scale=dims[i] ** -0.5) for i in range(n_layers)),
        layer_bs=tuple(r(g, dims[i + 1], scale=0.1) for i in range(n_layers)),
        head_w=r(g, 3, dims[-1], scale=dims[-1] ** -0.5), head_b=r(g, 3, scale=0.1),
        att_w=r(g, g * dims[-1], scale=0.1), att_b=r(g, scale=0.1),
    )


PCGEN_GENERAL_REL_L2 = 2e-3  # TF32 component products (the flagship kernel's fp16 mantissa), fp32 elsewhere


@pytest.mark.parametrize('dims,g,dm,b,n', [
    ((1024, 500, 300, 77), 8, 200, 16, 2048),  # path E's decoder
    ((1024, 500, 300, 77), 8, 200, 1, 2048),
    ((512, 256), 2, 8, 2, 512),  # one layer
    ((256, 512, 300, 200, 64), 3, 256, 2, 512),  # four, expanding first
    ((128, 96, 40, 9), 5, 16, 2, 300),  # a tail tile
    ((1024, 1024, 256, 8), 8, 64, 2, 256),  # last width 8: the flagship kernel's n16 product refuses it
    ((2048, 2048, 1024), 2, 8, 1, 256),  # activations past shared memory: the global scratch
])
@pytest.mark.parametrize('slope', [0.0, 0.2])
def test_pcgen_general_matches_plain(dev, dims, g, dm, b, n, slope):
    pack = _general_pack(dev, dims, g, dm)
    assert not pcgen.flagship(dm, dims, g)
    m, w = torch.relu(_randn((b, n, dm), 3, dev)), _randn((b, dims[0]), 4, dev)
    api.reset_launch_counts()
    got = api.pcgen_mix(m, w, pack, tau=5.0, act_slope=slope)
    assert api.launch_counts()['pcgen_general'] == 1 and api.launch_counts()['pcgen_mix'] == 0
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=slope)) <= PCGEN_GENERAL_REL_L2


@pytest.mark.parametrize('dims', [(256, 128, 64, 32, 16, 8), (256, 256, 128, 64, 32, 16, 8)])
def test_pcgen_general_any_depth_matches_plain(dev, dims):
    """Five and six component layers, through the kernel's device table."""
    pack = _general_pack(dev, dims, 2, 8)
    m, w = torch.relu(_randn((2, 512, 8), 3, dev)), _randn((2, dims[0]), 4, dev)
    got = pcgen.pcgen_general_cuda(m, w, pack, tau=5.0, act_slope=0.0)
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)) <= PCGEN_GENERAL_REL_L2


@pytest.mark.parametrize('c', [17, 130, 511, 1, 34])
def test_pools_at_any_width(dev, c):
    """The eval max-pool, the training max-pool with its slot and the slot
    scatter bit-exact, the sum-pool within 1e-5 and bit-equal to the slot
    order on the CPU, at widths off the kernels' groups of four."""
    x = _randn((8, 2048, c), c, dev)
    idx = _graph(8, 2048, 25, dev, c)
    assert torch.equal(gather.graph_max_pool_cuda(x, idx), ops.graph_max_pool(x, idx))
    out, slots = gather.graph_max_pool_src_cuda(x, idx)
    want, want_slots = ops.graph_max_pool_slots_strict(x, idx)
    assert out.shape == x.shape and torch.equal(out, want) and torch.equal(slots, want_slots)
    g = _randn((8, 2048, c), c + 1, dev)
    got = gather.scatter_add_slots_cuda(g, idx, slots, 2048)
    assert torch.equal(got.cpu(), ops.scatter_add_slots(g.cpu(), idx.cpu(), slots.cpu(), 2048))
    s = gather.graph_sum_pool_cuda(x, idx)
    assert torch.equal(s.cpu(), ops.graph_sum_pool_slot_order(x.cpu(), idx.cpu()))


def test_stage1_step_is_bit_reproducible_by_default(dev):
    """Two flagship stage-1 steps (ChamferEMD, batch 4 x 2048) from the same
    state in default mode give bit-equal gradients: no operation of the step
    adds in an order that changes from run to run."""
    from pccf_torch.config import SliceConfig
    from pccf_torch.data import synthetic
    from pccf_torch.data.structures import Inputs, Targets
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn.layers import init_for_training
    from pccf_torch.train import Trainer, get_autoencoder_loss

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = SliceConfig()
    model = build_vqvae(cfg)
    init_for_training(model, 0)
    state = model.state_dict()
    batch = torch.from_numpy(synthetic.batch(3, 4, cfg.data.n_input_points)).to(dev)

    def grads():
        m = build_vqvae(cfg)
        m.load_state_dict(state)
        m = m.to(dev)
        Trainer(m, get_autoencoder_loss(cfg), cfg.autoencoder.train, 100, seed=0).run_step(Inputs(batch),
                                                                                            Targets(batch))
        return {k: p.grad for k, p in m.named_parameters() if p.grad is not None}

    a, b = grads(), grads()
    assert a.keys() == b.keys() and len(a) == 32
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize('n_clouds', [130, 778])
def test_index_k_neighbours_on_the_card(dev, n_clouds):
    """The ModelNet reader's precompute (chunks of 64 clouds of 2048 points,
    k = 25, the desk / table split's 778 clouds) on the card against the
    plain kNN, neighbour sets up to near-ties, int32 host indices."""
    from pccf_torch.data.modelnet import index_k_neighbours

    pcs = np.random.default_rng(n_clouds).standard_normal((n_clouds, 2048, 3)).astype(np.float32)
    got = index_k_neighbours(pcs, 25, dev)
    assert got.dtype == np.int32 and got.shape == (n_clouds, 2048, 25)
    for i in range(0, n_clouds, 64):
        x = torch.from_numpy(pcs[i: i + 64]).to(dev)
        assert _knn_agrees(x, torch.from_numpy(got[i: i + 64]).to(dev), knn.plain(x, 25), 25)


# ------------------------------------------------------------- the auction EMD

AUCTION_TRAIN = dict(eps=0.005, iters=50)
AUCTION_EVAL = dict(eps=0.002, iters=10000)


def _grid_clouds(b, n, m, seed, dev):
    """Clouds on a grid of 1/8 in the unit box (every squared distance exact
    in float32, equal distances tie exactly): the second holds each of its
    points twice, the first pairs of equal points (equal bids on one item)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 9, (b, m // 2, 3)) / 8
    x = rng.integers(0, 9, (b, n, 3)) / 8
    x[:, 1::2] = x[:, 0:n - 1:2]
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(np.concatenate([y, y], axis=1).astype(np.float32)).to(dev))


@pytest.mark.parametrize('b,n,m,contract,k_active', [
    (1, 2048, 2048, AUCTION_TRAIN, None),
    (1, 512, 512, AUCTION_EVAL, None),
    (2, 300, 512, AUCTION_TRAIN, None),
    (3, 700, 700, AUCTION_TRAIN, 64),
    (1, 8192, 8192, AUCTION_TRAIN, None),
    (2, 5, 40, AUCTION_EVAL, None),
    (1, 2048, 2048, AUCTION_EVAL, None),  # below the tail's threshold for thousands of rounds
    (1, 1024, 1024, AUCTION_EVAL, 600),  # the compaction, then the list on the cluster, then the tail
    (1, 5216, 5216, AUCTION_TRAIN, None),  # the largest with room for the tail
    (1, 5224, 5224, AUCTION_TRAIN, None),  # the smallest without: every round on the cluster
    (1, 16384, 16384, AUCTION_TRAIN, None),
    (1, 19264, 19264, AUCTION_TRAIN, None),  # the largest state in shared memory
    (1, 19272, 19272, AUCTION_TRAIN, None),  # the smallest in global scratch
    (40, 2048, 2048, AUCTION_TRAIN, None),  # more clouds than the card holds clusters of 16 or 8 at once
    (8, 16384, 16384, AUCTION_TRAIN, None),  # clusters of 8 at 16384 points
    (140, 256, 256, AUCTION_TRAIN, None),  # more clouds than the card holds clusters of one block: waves
])
def test_auction_emd_matches_plain(dev, b, n, m, contract, k_active):
    x1, x2 = torch.rand((b, n, 3), device=dev), torch.rand((b, m, 3), device=dev)
    k = auction_emd.bidder_cap(n, k_active)
    p, held = auction_emd.library_plan(b, n, m, k), auction_emd.resident_clusters()
    assert p == auction_emd.plan(b, n, m, k, held)
    assert bool(p.shared) == (n <= 19264) and bool(p.tail) == (n <= 5216)
    widest = 16 if m >= 1024 else 8 if m >= 512 else 4 if m >= 256 else 1
    assert p.cluster == widest or b > held[widest.bit_length() - 1]  # halved only where the clouds outnumber
    assert b <= held[p.cluster.bit_length() - 1] or p.cluster == 1  # one wave where the card allows
    assert (b > held[0]) == (b == 140)
    got = auction_emd.auction_emd_cuda(x1, x2, **contract, k_active=k_active)
    want = auction_emd.plain(x1, x2, **contract, k_active=k_active)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(got[3][:, 0].max()) <= contract['iters']
    if contract is AUCTION_EVAL:
        assert int(got[1].min()) >= 0
    again = auction_emd.auction_emd_cuda(x1, x2, **contract, k_active=k_active)
    assert all(torch.equal(a, w) for a, w in zip(got, again))


@pytest.mark.parametrize('b,n,m,contract,k_active', [
    (2, 48, 48, AUCTION_EVAL, None),
    (1, 2048, 2048, AUCTION_TRAIN, None),
    (1, 2048, 2048, AUCTION_EVAL, None),
    (2, 1000, 1024, AUCTION_TRAIN, 100),
])
def test_auction_emd_ties_match_plain(dev, b, n, m, contract, k_active):
    """Exact ties in the distances, the benefits and the bids: the kernel's
    key on the row picks what the plain version's lowest slot picks."""
    x1, x2 = _grid_clouds(b, n, m, 7 + n, dev)
    got = auction_emd.auction_emd_cuda(x1, x2, **contract, k_active=k_active)
    want = auction_emd.plain(x1, x2, **contract, k_active=k_active)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize('contract', [AUCTION_TRAIN, AUCTION_EVAL])
def test_auction_emd_concentrated_bids_match_plain(dev, contract):
    """256 coincident points in x1: once the other rows are assigned they
    all bid on one item, so one block's items take every bid of a round and
    its list every loser."""
    gen = torch.Generator().manual_seed(23)
    x1, x2 = torch.rand((1, 2048, 3), generator=gen), torch.rand((1, 2048, 3), generator=gen)
    x1[0, torch.randperm(2048, generator=gen)[:256]] = x1[0, 0].clone()
    x1, x2 = x1.to(dev), x2.to(dev)
    got = auction_emd.auction_emd_cuda(x1, x2, **contract)
    want = auction_emd.plain(x1, x2, **contract)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_auction_plan_matches_the_library(dev):
    """The Python mirror of ``auction_plan``, given the card's clusters at
    once (``pccf_auction_resident``: one block a cloud on every SM, fewer
    clusters as they widen, each size launchable), against
    ``pccf_auction_plan``."""
    held = auction_emd.resident_clusters()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert held[0] == sms and all(0 < c * 2 ** i <= sms for i, c in enumerate(held))
    assert all(a >= b for a, b in zip(held, held[1:]))
    for n, m, k in [(5, 40, 5), (64, 64, 64), (300, 512, 256), (700, 700, 64), (1024, 1024, 600),
                    (1536, 2048, 384), (2048, 2048, 512), (4096, 4096, 1024), (16384, 16384, 4096),
                    (19264, 19264, 4816), (19272, 19272, 4818), (100000, 100000, 25000)]:
        for b in (1, 7, 8, 16, 40, 140):
            assert auction_emd.plan(b, n, m, k, held) == auction_emd.library_plan(b, n, m, k), (b, n, m, k)


def test_auction_emd_launches_once_and_its_gradient_matches_the_cpu(dev):
    x1 = torch.rand((2, 1024, 3), device=dev).requires_grad_(True)
    x2 = torch.rand((2, 1024, 3), device=dev).requires_grad_(True)
    api.reset_launch_counts()
    dis, assignment = api.auction_emd(x1, x2, **AUCTION_TRAIN)
    dis.sum().backward()
    torch.cuda.synchronize()
    counts = api.launch_counts()
    assert counts['auction_emd'] == 1 and counts['scatter_add_rows'] == 1
    c1, c2 = x1.detach().cpu().requires_grad_(True), x2.detach().cpu().requires_grad_(True)
    cdis, cassignment = api.auction_emd(c1, c2, **AUCTION_TRAIN)
    cdis.sum().backward()
    assert torch.equal(assignment.cpu(), cassignment) and torch.equal(dis.cpu(), cdis)
    assert _rel_l2(x1.grad.cpu(), c1.grad) <= 1e-6 and _rel_l2(x2.grad.cpu(), c2.grad) <= 1e-6


def test_auction_dispatch_raises_rather_than_falling_back(dev, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('the plain auction ran on CUDA tensors')

    monkeypatch.setattr(auction_emd, 'plain', boom)
    x = torch.rand((1, 64, 3), device=dev)
    with pytest.raises(ValueError, match='N <= M'):
        api.auction_emd(x, x[:, :32])
    with pytest.raises(ValueError):
        auction_emd.auction_emd_cuda(x.double(), x.double())

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue

    monkeypatch.setattr(auction_emd._build, 'lib', lambda: Refusing())
    with pytest.raises(ValueError, match='pccf_auction_emd: the kernel does not cover'):
        api.auction_emd(x, x)


@pytest.mark.parametrize('n,m', [(1024, 2048), (256, 512), (100, 300)])
def test_nn_distance_dispatch_on_the_card(dev, n, m):
    """Inside the gate (both counts multiples of 256) one kernel launch,
    bit-exact to the plain version; outside it the plain operations."""
    x = (_randn((2, n, 3), 40, dev) * 0.5).requires_grad_(True)
    y = (_randn((2, m, 3), 41, dev) * 0.5).requires_grad_(True)
    api.reset_launch_counts()
    got = api.nn_distance(x, y)
    inside = n % 256 == 0 and m % 256 == 0
    assert api.launch_counts()['nn_distance'] == int(inside)
    if inside:
        for a, w in zip(got, chamfer.plain(x.detach(), y.detach())):
            assert torch.equal(a, w)
    (got[0].sum() + 2 * got[2].sum()).backward()
    cx, cy = x.detach().cpu().requires_grad_(True), y.detach().cpu().requires_grad_(True)
    want = api.nn_distance(cx, cy)
    (want[0].sum() + 2 * want[2].sum()).backward()
    assert _rel_l2(x.grad.cpu(), cx.grad) <= 1e-6 and _rel_l2(y.grad.cpu(), cy.grad) <= 1e-6


def _shares(pack, mp):
    """The packs of ``mp`` ranks' components, ``att_b`` on the first."""
    count = pack.head_w.shape[0] // mp
    return [(r * count, pack.share(r * count, count, r == 0)) for r in range(mp)]


@pytest.mark.parametrize('mp', [2, 4])
@pytest.mark.parametrize('kind', ['flagship', 'general'])
def test_pcgen_partial_matches_plain(dev, kind, mp):
    """The partial mode of either kernel on each of ``mp`` ranks' shares of
    eight components against its plain version (logits and heads), through
    ``api.pcgen_partial``'s dispatch; the shares' logits summed and their
    mixtures summed against the unsharded plain mix."""
    if kind == 'flagship':
        pack, dm, n, tol, name = _pcgen_pack(dev, g=8, dims=(1024, 1024, 256, 16), dm=64), 64, 2048, \
            PCGEN_REL_L2, 'pcgen_mix_partial'
    else:
        pack, dm, n, tol, name = _general_pack(dev, (512, 300, 200, 77), 8, 40), 40, 1000, PCGEN_GENERAL_REL_L2, \
            'pcgen_general_partial'
    m, w = torch.relu(_randn((2, n, dm), 3, dev)), _randn((2, pack.map_w.shape[0]), 4, dev)
    logits, mixed = 0, []
    for g0, share in _shares(pack, mp):
        api.reset_launch_counts()
        got_l, got_h = api.pcgen_partial(m, w, share, act_slope=0.0)
        assert api.launch_counts()[name] == 1 and sum(api.launch_counts().values()) == 1
        want_l, want_h = pcgen.plain_partial(m, w, share, act_slope=0.0)
        assert got_l.shape == (2, n, 8) and got_h.shape == (2, n, 8 // mp, 3)
        assert _rel_l2(got_l, want_l) <= tol and _rel_l2(got_h, want_h) <= tol
        logits = logits + got_l
        mixed.append((g0, got_h))
    out = sum(ops.pcgen_mix_share(logits, h, g0, 5.0) for g0, h in mixed)
    assert _rel_l2(out, pcgen.plain(m, w, pack, tau=5.0, act_slope=0.0)) <= tol


@pytest.mark.parametrize('n', [48, 200])
def test_pcgen_partial_masks_the_tail_tile(dev, n):
    """The flagship kernel's partial mode with one component a rank (mp = G
    = 3) at N off the 64-point tile: the rows past N are not stored."""
    pack = _pcgen_pack(dev)
    m, w = torch.relu(_randn((2, n, 8), 3, dev)), _randn((2, 256), 4, dev)
    for _, share in _shares(pack, 3):
        got_l, got_h = pcgen.pcgen_mix_partial_cuda(m, w, share, act_slope=0.0)
        want_l, want_h = pcgen.plain_partial(m, w, share, act_slope=0.0)
        assert _rel_l2(got_l, want_l) <= PCGEN_REL_L2 and _rel_l2(got_h, want_h) <= PCGEN_REL_L2


# -------------------------------------------- the serving ops and artifacts


def _op_cases(dev):
    """Each serving op's arguments on the card, at the small models' shapes."""
    from pccf_torch.kernels import library

    vq, _ = _small_models()
    vq = vq.to(dev)
    vq.prepack()
    wae = vq.w_autoencoder
    x = _randn((2, 256, 3), 30, dev)
    out_x = _randn((2, 256, 3), 31, dev)
    _, f_idx, f_mean = library.graph_filter(out_x)
    tokens = _randn((2, 128, 128), 32, dev)
    m = torch.relu(_randn((2, 256, 8), 33, dev))
    cases = {
        'knn': (x, 8),
        'graph_max_pool': (_randn((2, 256, 64), 34, dev), library.knn(x, 8)),
        'cvae_cf': (_randn((2, 128, 4), 35, dev), torch.softmax(_randn((2, 2), 36, dev), -1),
                    *library.cvae_tensors(wae.packed), list(wae.packed.heads), False),
        'pcgen_mix': (m, _randn((2, 512), 37, dev), library.pcgen_tensors(vq.decoder.packed), 5.0, 0.0),
        'wformer_encoder': (tokens, library.stack_tensors(wformer.pack_encoder(wae.encoder.layers),
                                                          library.ENCODER_KEYS), 2),
        'wformer_decoder': (tokens, _randn((2, 128, 128), 38, dev),
                            library.stack_tensors(wformer.pack_decoder(wae.decoder.layers), library.DECODER_KEYS), 2),
        'graph_filter': (out_x.clone().requires_grad_(True),),
        'graph_filter_backward': (out_x, f_idx, f_mean, _randn((2, 256, 3), 39, dev)),
    }
    cases['pcgen_general'] = cases['pcgen_mix']
    return cases


@pytest.mark.parametrize('name', ['knn', 'graph_max_pool', 'cvae_cf', 'pcgen_mix', 'pcgen_general', 'wformer_encoder',
                                  'wformer_decoder', 'graph_filter', 'graph_filter_backward'])
def test_serving_ops_pass_opcheck_on_cuda(dev, name):
    """Schema, autograd registration, fake kernel (shapes and types of the
    kernel's outputs, kNN's int32) and AOT dispatch of each ``torch.ops.pccf``
    op on CUDA tensors, where it launches the hand-written kernel."""
    from pccf_torch.kernels import library

    before = api.launch_counts()
    torch.library.opcheck(library.OPS[name], _op_cases(dev)[name])
    assert api.launch_counts()[name] > before[name]


def test_artifact_on_the_card_matches_the_live_server(card_and_cpu_servers, tmp_path):
    """The card server exported for the card and the CPU: the card artifact's
    requests (a chunked one too) and generation within 1e-5 of the live
    server's with the same launches, the CPU artifact within 1e-5 of the
    same model on the CPU."""
    from pccf_torch.export import export_server, load_artifact

    card, cpu = card_and_cpu_servers
    manifest = export_server(card, tmp_path, 256, 2, platforms=['cuda', 'cpu'])
    assert manifest['platforms'] == ['cuda', 'cpu']
    art, cpu_art = load_artifact(tmp_path, 'cuda'), load_artifact(tmp_path, 'cpu')
    clouds = (np.random.default_rng(21).standard_normal((6, 256, 3)) / 2).astype(np.float32)
    for call in (lambda s: s.counterfactual(clouds, np.arange(6) % 2, None, 0.75, np.arange(6)),
                 lambda s: s.classify(clouds[:3]), lambda s: s.generate(5, seed=4)):
        api.reset_launch_counts()
        want = call(card)
        want_counts = api.launch_counts()
        api.reset_launch_counts()
        got = call(art)
        assert api.launch_counts() == want_counts
        assert np.abs(got - want).max() <= 1e-5
        assert np.abs(call(cpu_art) - call(cpu)).max() <= 1e-5

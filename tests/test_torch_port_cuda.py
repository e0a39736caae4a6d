"""pccf_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one (a CUDA
kernel has no interpret mode).  The file imports neither JAX nor the tests'
conftest helpers, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerances: kNN neighbour sets equal up to near-ties (a differing neighbour
must be as near, in float64, within 1e-5 of the squared distance scale),
with the lowest index first on exact duplicates; max-pool bit-exact; pcgen_mix
rel-L2 1e-2 (bf16 weights); the CVAE chain rel-L2 1e-4 (3xTF32 products);
gather, sum-pool and pool-with-slot bit-exact except sum-pool's order of
addition (1e-5); the scatter-adds 1e-5 of the largest entry (fp32 atomics
add in an order that changes from run to run); EMD cost 1e-4 relative and
gradients rel-L2 1e-3 (exp and the row and column sums recomputed in another
order), Chamfer minima and argmins exact (same float32 squared distances).
"""

import numpy as np
import pytest
import torch

from pccf_torch.kernels import api, cvae, emd, gather, knn, ops, pcgen

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


def test_graph_max_pool_bit_exact(dev):
    x = _randn((2, 512, 64), 2, dev)
    idx = torch.randint(0, 512, (2, 512, 25), dtype=torch.int32, device=dev)
    assert torch.equal(gather.graph_max_pool_cuda(x, idx), ops.graph_max_pool(x, idx))


def _pcgen_pack(dev, g=3, dims=(256, 256, 64, 16)):
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return pcgen.PCGenPack(
        map_w=r(dims[0], 8, scale=0.3), map_b=r(dims[0], scale=0.1),
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
    assert _rel_l2(got, pcgen.plain(m, w, pack, tau=5.0, act_slope=slope)) <= 1e-2


def test_pcgen_mix_refuses_shapes_it_does_not_cover(dev):
    m, w = torch.relu(_randn((1, 48, 8), 3, dev)), _randn((1, 256), 4, dev)  # 48 points: not 32-row tiles
    with pytest.raises(ValueError, match='does not cover'):
        pcgen.pcgen_mix_cuda(m, w, _pcgen_pack(dev), tau=5.0, act_slope=0.0)


def _layer(d, f, gen, dev, decoder=False):
    def r(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    p = {'ln1_w': 1 + r(d, scale=0.1), 'ln1_b': r(d, scale=0.1), 'w_qkv': r(d, 3 * d, scale=d ** -0.5),
         'b_qkv': r(3 * d, scale=0.1), 'w_o': r(d, d, scale=d ** -0.5), 'b_o': r(d, scale=0.1),
         'ln2_w': 1 + r(d, scale=0.1), 'ln2_b': r(d, scale=0.1), 'w1': r(d, f, scale=d ** -0.5),
         'b1': r(f, scale=0.1), 'w2': r(f, d, scale=f ** -0.5), 'b2': r(d, scale=0.1)}
    if decoder:
        p.update({'lnx_w': 1 + r(d, scale=0.1), 'lnx_b': r(d, scale=0.1), 'xw_q': r(d, d, scale=d ** -0.5),
                  'xb_q': r(d, scale=0.1), 'xw_kv': r(d, 2 * d, scale=d ** -0.5), 'xb_kv': r(2 * d, scale=0.1),
                  'xw_o': r(d, d, scale=d ** -0.5), 'xb_o': r(d, scale=0.1)})
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
    """A model whose structural gate fails has no kernel path on the card:
    it raises instead of running the plain modules there."""
    from pccf_torch.data.structures import WInputs
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.decoders import PCGenDecoder
    from pccf_torch.nn.layers import gelu_exact, relu

    wae = WAutoEncoder(  # unequal proj_dim
        encoder=tw.TransformerWEncoder(4, 8, 64, 128, 2, (64,), gelu_exact),
        decoder=tw.TransformerWDecoder(4, 8, 6, 64, 64, 1, (64,), gelu_exact),
        z2_prior=tw.ConditionalPrior(3, 64, 6),
        z2_posterior=tw.TransformerWConditionalEncoder(4, 3, 6, 64, 128, 2, (64,), gelu_exact),
        n_codes=64, embedding_dim=4, z1_dim=8, z2_dim=6, n_classes=3,
    ).to(dev).eval()
    assert not wae.fused_ok()
    with pytest.raises(NotImplementedError, match='wformer'):
        wae.generate_counterfactual(WInputs(_randn((2, 256), 1, dev), _randn((2, 3), 2, dev)),
                                    _randn((64, 8, 4), 3, dev), 1)

    dec = PCGenDecoder(w_dim=128, sample_dim=4, n_components=1, map_dims=(8,), conv_dims=(128, 64, 16), tau=5.0,
                       act=relu).to(dev).eval()
    assert not dec.fused_ok()
    with pytest.raises(NotImplementedError, match='pcgen_mix gate'):
        dec(_randn((2, 128), 4, dev), _randn((2, 64, 4), 5, dev))


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


@pytest.mark.parametrize('c,k', [(3, 4), (128, 25)])
def test_gather_and_row_scatter_match_plain(dev, c, k):
    x = _randn((2, 2048, c), 10, dev)
    idx = _graph(2, 2048, k, dev, 11)
    assert torch.equal(gather.gather_neighbors_cuda(x, idx), ops.gather_neighbors(x, idx))
    g = _randn((2, 2048, c), 12, dev)
    assert _max_rel(gather.scatter_add_rows_cuda(g, idx, 2048), ops.scatter_add_rows(g, idx, 2048)) <= 1e-5


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

"""pccf_torch kernel modules against the JAX package, on the CPU.

For each kernel of the counterfactual slice, the port's plain version (what a
CPU tensor runs) is held (a) against the JAX Pallas kernel in interpret mode,
patched in the way tests/test_kernels_interpret.py does, and (b) against the
JAX jnp path in float32.  The modules that hold the PCGen and CVAE kernels are
compared in tests/test_torch_port_modules.py.  Inputs are made with numpy
from a seed and handed to both frameworks.

Tolerances: kNN compares exact neighbour sets (and the order where there are
no ties), max-pool is bit-exact, float32 chains 1e-4.
"""

import functools
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.kernels import ops as jops
from pccf_torch.kernels import _build, api, chamfer, cvae, emd, gather, knn as tknn, ops, pcgen, sinkhorn

torch.set_num_threads(1)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _cloud(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sets_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return all(set(x) == set(y) for x, y in zip(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])))


# --------------------------------------------------------------------- kNN


@pytest.mark.parametrize('n,c,k', [(256, 3, 25), (256, 64, 20), (256, 128, 25), (300, 5, 4)])
def test_knn_matches_jnp(n, c, k):
    x = _cloud((2, n, c), seed=n + c + k)
    got = ops.knn(torch.from_numpy(x), k).numpy()
    want = np.asarray(jops.knn(jnp.asarray(x), k))
    assert got.dtype == np.int32 and got.shape == (2, n, k)
    assert _sets_equal(got, want)
    np.testing.assert_array_equal(got, want)  # no ties in random clouds: same order too


def test_knn_matches_pallas_interpret(interpret_pallas):
    from pccf.kernels.pallas_knn import knn_tpu

    x = _cloud((2, 256, 16), seed=3)
    got = ops.knn(torch.from_numpy(x), 9).numpy()
    want = np.asarray(knn_tpu(jnp.asarray(x), 9))
    assert _sets_equal(got, want)
    assert (got[..., 0] == np.arange(256)).all()  # self in slot 0


def test_knn_duplicates_lowest_index_first():
    """Exact duplicate points (ModelNet resampling makes them): equal
    distances keep the lower index first, as jax.lax.top_k does."""
    x = _cloud((1, 64, 3), seed=4)
    x[0, 40] = x[0, 7]
    x[0, 50] = x[0, 7]
    got = ops.knn(torch.from_numpy(x), 4).numpy()
    want = np.asarray(jops.knn(jnp.asarray(x), 4))
    for i in (7, 40, 50):
        assert set(got[0, i, :3]) == {7, 40, 50}
        assert set(got[0, i]) == set(want[0, i])
    # a 1-NN of a duplicate is the lowest-index copy, not itself
    np.testing.assert_array_equal(ops.knn(torch.from_numpy(x), 1).numpy()[0, [7, 40, 50], 0], [7, 7, 7])


def test_self_square_distance_matches_jnp():
    x = _cloud((2, 64, 8), seed=5)
    np.testing.assert_allclose(
        ops.self_square_distance(torch.from_numpy(x)).numpy(),
        np.asarray(jops.self_square_distance(jnp.asarray(x))),
        rtol=1e-4, atol=1e-4,
    )


# ---------------------------------------------------------- graph max-pool


@pytest.mark.parametrize('f,k', [(64, 25), (256, 20)])
def test_graph_max_pool_bit_exact_vs_jnp(f, k):
    rng = np.random.default_rng(f + k)
    x = rng.standard_normal((2, 256, f)).astype(np.float32)
    idx = rng.integers(0, 256, (2, 256, k)).astype(np.int32)
    got = ops.graph_max_pool(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    want = np.asarray(jops.graph_max_pool(jnp.asarray(x), jnp.asarray(idx)))
    assert (got == want).all()


def test_graph_max_pool_bit_exact_vs_pallas_interpret(interpret_pallas):
    from pccf.kernels.pallas_gather import graph_max_pool_tpu

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 256, 16)).astype(np.float32)
    idx = rng.integers(0, 256, (2, 256, 5)).astype(np.int32)
    got = ops.graph_max_pool(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert (got == np.asarray(graph_max_pool_tpu(jnp.asarray(x), jnp.asarray(idx)))).all()


# ------------------------------------------------------------ parity traps


@pytest.mark.parametrize('d_in,d_out', [(4, 10), (8, 8), (16, 4), (3, 7), (128, 256)])
def test_interleave_residual_column_order(d_in, d_out):
    x = _cloud((2, 5, d_in), seed=d_in * d_out)
    got = ops.interleave_residual(torch.from_numpy(x), d_out).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.interleave_residual(jnp.asarray(x), d_out)))
    reps = d_out // d_in + 1
    np.testing.assert_array_equal(got, x[..., np.arange(d_out) // reps])


def test_bn_fold_matches_pallas_pcgen():
    from pccf.kernels.pallas_pcgen import fold_bn_affine
    from pccf_torch.nn.layers import BatchNorm

    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 8, 6)).astype(np.float32)  # flax (G, in, out)
    scale, bias, mean = (rng.standard_normal((2, 6)).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, (2, 6)).astype(np.float32)
    wj, bj = fold_bn_affine(*(jnp.asarray(a) for a in (w, scale, bias, mean, var)))
    bn = BatchNorm(2, 6)  # the stacked BatchNorm of the PCGen components, folded as PCGenDecoder.pack folds it
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in zip(('weight', 'bias', 'running_mean', 'running_var'),
                                                                (scale, bias, mean, var))})
    with torch.no_grad():
        a_t, bt = bn.affine()
        wt = torch.from_numpy(np.swapaxes(w, -1, -2)) * a_t[..., :, None]
    a = scale / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(bt.numpy(), bias - mean * a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), rtol=1e-6, atol=1e-6)
    # the JAX pack rounds W to bf16; the port keeps fp32 and rounds in the wrapper
    np.testing.assert_allclose(np.asarray(wj, np.float32), np.swapaxes(wt.numpy(), -1, -2), rtol=1e-2)
    np.testing.assert_allclose(wt.numpy(), np.swapaxes(w * a[:, None, :], -1, -2), rtol=1e-6)


def test_layer_norm_eps_is_flax_default():
    from pccf.kernels.pallas_wformer import _LN_EPS, _layer_norm

    assert _LN_EPS == 1e-6
    x = (_cloud((4, 32), seed=8) * 1e-3).astype(np.float32)  # small variance: eps matters
    w, b = np.ones(32, np.float32), np.zeros(32, np.float32)
    got = ops.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    want = np.asarray(_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    torch_default = torch.nn.functional.layer_norm(torch.from_numpy(x), (32,)).numpy()
    assert np.abs(torch_default - want).max() > 1e-3  # torch's 1e-5 would not match


def test_gelu_is_exact_erf():
    from pccf.nn.layers import gelu_exact

    x = np.linspace(-5, 5, 101).astype(np.float32)
    got = ops.gelu_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(gelu_exact(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    ref = np.asarray([0.5 * v * (1 + math.erf(v / math.sqrt(2))) for v in x.astype(np.float64)])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    tanh_form = torch.nn.functional.gelu(torch.from_numpy(x), approximate='tanh').numpy()
    assert np.abs(tanh_form - got).max() > 1e-5


def test_vq_assign_and_lookup_match_jnp():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 16 * 4)).astype(np.float32)
    book = rng.standard_normal((16, 8, 4)).astype(np.float32)
    emb, idx, d2 = ops.vq_assign(torch.from_numpy(x), torch.from_numpy(book))
    jemb, jidx, jd2 = jops.vq_assign(jnp.asarray(x), jnp.asarray(book))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    np.testing.assert_array_equal(
        ops.vq_lookup(idx, torch.from_numpy(book)).numpy(), np.asarray(jops.vq_lookup(jidx, jnp.asarray(book)))
    )


def test_temperature_softmax_matches_jnp():
    from pccf.nn.layers import temperature_softmax

    x = _cloud((4, 5), seed=10)
    np.testing.assert_allclose(
        ops.temperature_softmax(torch.from_numpy(x), 5.0).numpy(),
        np.asarray(temperature_softmax(jnp.asarray(x), 5.0)),
        rtol=1e-6, atol=1e-6,
    )


# ------------------------------------------------------------------ dispatch


def test_cpu_tensors_take_the_plain_versions():
    api.reset_launch_counts()
    x = torch.from_numpy(_cloud((1, 64, 4), seed=11))
    idx = api.knn(x, 5)
    api.graph_max_pool(x, idx)
    xg = x.clone().requires_grad_(True)
    (api.graph_max_pool(xg, idx).sum() + api.graph_sum_pool(xg, idx).sum() + api.graph_filtering(xg[..., :3]).sum()
     + sum(api.chamfer_match_cost(xg[..., :3], x[..., 1:])).sum() + api.chamfer(xg[..., :3], x[..., 1:]).sum()
     + sum(api.chamfer_sinkhorn_cost(xg[..., :3], x[..., 1:])).sum()
     + api.auction_emd(xg[..., :3], x[..., 1:])[0].sum() + api.nn_distance(xg[..., :3], x[..., 1:])[0].sum()).backward()
    tokens = torch.from_numpy(_cloud((1, 64, 64), seed=12))
    eye, ones, zeros = torch.eye(64), torch.ones(64), torch.zeros(64)
    layer = {'ln1_w': ones, 'ln1_b': zeros, 'ln2_w': ones, 'ln2_b': zeros}
    cross = {'lnx_w': ones, 'lnx_b': zeros}
    for name in ('q', 'k', 'v', 'o', '1', '2'):
        layer.update({f'w{name}': eye, f'b{name}': zeros})
    for name in ('xq', 'xk', 'xv', 'xo'):
        cross.update({f'w{name}': eye, f'b{name}': zeros})
    assert api.wformer_encoder(tokens, [layer], 1).shape == tokens.shape
    assert api.wformer_decoder(tokens, tokens, [{**layer, **cross}], 1).shape == tokens.shape
    assert set(api.launch_counts()) == {'knn', 'graph_max_pool', 'pcgen_mix', 'pcgen_general', 'cvae_cf',
                                        'gather_neighbors',
                                        'scatter_add_rows', 'graph_max_pool_src', 'scatter_add_slots',
                                        'graph_sum_pool', 'chamfer_match_cost', 'wformer_encoder',
                                        'wformer_decoder', 'gemm_bf16w', 'nn_distance', 'sinkhorn_cost',
                                        'graph_filter', 'graph_filter_backward', 'auction_emd', 'attention_wide',
                                        'pcgen_mix_partial', 'pcgen_general_partial'}
    assert set(api.launch_counts().values()) == {0}


@pytest.mark.parametrize(
    'call',
    [
        lambda x: tknn.knn_cuda(x, 4),
        lambda x: gather.graph_max_pool_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32)),
        lambda x: cvae.cvae_cf_cuda(x, torch.zeros((1, 2)), None),
        lambda x: pcgen.pcgen_mix_cuda(x, torch.zeros((1, 4)), None, tau=1.0, act_slope=0.0),
        lambda x: gather.gather_neighbors_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32)),
        lambda x: gather.scatter_add_rows_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32), 64),
        lambda x: gather.graph_max_pool_src_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32)),
        lambda x: gather.scatter_add_slots_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32),
                                                torch.zeros((1, 64, 4), dtype=torch.uint8), 64),
        lambda x: gather.graph_sum_pool_cuda(x, torch.zeros((1, 64, 4), dtype=torch.int32)),
        lambda x: emd.chamfer_match_cost_cuda(x[..., :3].contiguous(), x[..., :3].contiguous()),
        lambda x: chamfer.nn_distance_cuda(x[..., :3].contiguous(), x[..., :3].contiguous()),
        lambda x: sinkhorn.sinkhorn_cost_cuda(x[..., :3].contiguous(), x[..., :3].contiguous()),
    ],
)
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    x = torch.zeros((1, 64, 4))
    with pytest.raises(ValueError, match='CUDA tensor'):
        call(x)


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match='no kernel or plain version'):
        api.knn(torch.zeros((1, 8, 3), device='meta'), 2)


def test_check_names_the_shape_a_guard_refused():
    """The C guards are the one statement of what a kernel covers; a refusal
    comes back as cudaErrorInvalidValue and is raised with the shapes."""
    with pytest.raises(ValueError, match=r'pccf_knn: the kernel does not cover x \(1, 64, 6\), k=33'):
        _build.check('pccf_knn', _build.CUDA_ERROR_INVALID_VALUE, 'x (1, 64, 6), k=33')
    with pytest.raises(RuntimeError, match='CUDA error 700'):
        _build.check('pccf_knn', 700, 'x (1, 64, 6), k=4')
    _build.check('pccf_knn', 0, 'x (1, 64, 6), k=4')


def test_kernel_sources_cover_every_entry_point():
    """Every C entry point the wrappers bind is defined in csrc/, and the
    library is named by a hash of those sources."""
    sources = ''.join(p.read_text() for p in _build._sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in sources, name
    assert _build.library_path().parent == _build.BUILD_DIR

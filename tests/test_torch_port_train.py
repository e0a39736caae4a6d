"""The stage-1 training slice of pccf_torch against the JAX package, on the CPU.

Each new kernel's plain version (what a CPU tensor runs, through the same
autograd functions that launch the kernels on a CUDA tensor) is held against
the JAX jnp golden and against the JAX Pallas kernel in interpret mode,
forward and gradient; then graph filtering, the EdgeConv block and the PCGen
decoder in train mode; then one whole training step from the same flax
weights, batch, decoder sampling and Gumbel noise.  Inputs and noise are made
with numpy from a seed and handed to both frameworks.

Tolerances, each with its reason:
- gather: bit-exact forward (a copy), gradient 1e-6 (scatter sums in another
  order); max-pool bit-exact forward, gradient 1e-6 with first-winner ties;
  sum-pool 1e-5 (sums of 8 terms in another order);
- EMD cost rtol 5e-4 and gradients atol 5e-3, the tolerances of
  tests/test_kernels_interpret.py (exp of -4^7 · d² amplifies the rounding of
  d²); Chamfer value 1e-5 with equal argmins;
- modules and the whole step: 1e-4 relative on float32 chains, with the
  per-parameter gradient compared by rel-L2 <= 1e-4.  The first AdamW step
  moves a parameter by ``lr · g / (|g| + 1e-8)``: its error is about
  ``lr · 1e-8 / |g|`` times the relative error of that one gradient element,
  which is large where ``|g|`` is small.  So the parameters after the step
  are held at 1e-5 where the JAX gradient exceeds 1e-5, and elsewhere to a
  move of at most ``2 · lr``.
"""

import functools
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.kernels import api as japi, ops as jops
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.kernels import api, emd, ops

from tests.test_torch_port_modules import load_port, randomize_stats

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _graph(b, n, k, seed):
    return np.random.default_rng(seed).integers(0, n, (b, n, k)).astype(np.int32)


def _port_value_and_grad(fn, *arrays, cot):
    """fn's output and the gradient of <fn(*arrays), cot> for every array."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    torch.sum(out * torch.from_numpy(cot)).backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_value_and_grad(fn, *arrays, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@functools.partial(jax.jit, static_argnums=0)
def _jax_train_vjp(fn, params, x, cot):
    """``fn(params, x) -> (out, new_batch_stats)``: out, new stats, and the
    gradients of <out, cot> for params and x."""
    out, vjp, stats = jax.vjp(fn, params, x, has_aux=True)
    return out, stats, vjp(cot)


def _pallas(name):
    from pccf.kernels import pallas_gather

    return getattr(pallas_gather, name)


# ------------------------------------------------------------ gather family

JAX_GATHER = {
    'gather': ('gather_neighbors', 'gather_neighbors_tpu'),
    'max': ('graph_max_pool', 'graph_max_pool_tpu'),
    'sum': ('graph_sum_pool', 'graph_sum_pool_tpu'),
}
PORT_GATHER = {'gather': api.gather_neighbors, 'max': api.graph_max_pool, 'sum': api.graph_sum_pool}


def _gather_case(op, seed):
    b, n, c, k = 2, 256, (3 if op == 'gather' else 16), (4 if op == 'gather' else 9)
    x = _rand((b, n, c), seed)
    idx = _graph(b, n, k, seed + 1)
    if op == 'max':  # ties: exact duplicate rows, and a neighbour listed twice
        x[:, 40] = x[:, 7]
        idx[:, :, 3] = 7
        idx[:, :, 5] = 40
        idx[:, :, 6] = idx[:, :, 0]
    cot = _rand((b, n, k, c) if op == 'gather' else (b, n, c), seed + 2)
    return x, idx, cot


@pytest.mark.parametrize('op', ['gather', 'max', 'sum'])
@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
def test_gather_family_matches_jax(op, backend, request):
    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
    x, idx, cot = _gather_case(op, seed=len(op))
    golden, tpu = JAX_GATHER[op]
    jfn = getattr(jops, golden) if backend == 'jnp' else _pallas(tpu)
    want, (wgrad,) = _jax_value_and_grad(lambda a: jfn(a, jnp.asarray(idx)), x, cot=cot)
    got, (ggrad,) = _port_value_and_grad(lambda a: PORT_GATHER[op](a, torch.from_numpy(idx)), x, cot=cot)
    if op == 'sum':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ggrad, wgrad, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(ggrad, wgrad, rtol=1e-6, atol=1e-6)


def test_max_pool_slots_take_the_first_winner():
    x = np.zeros((1, 8, 4), np.float32)
    x[0, 2] = 1.0
    x[0, 5] = 1.0  # ties with row 2 in every channel
    idx = np.asarray([[[0, 5, 2, 5]] * 8], np.int32)
    out, slots = ops.graph_max_pool_slots(torch.from_numpy(x), torch.from_numpy(idx))
    assert slots.dtype == torch.uint8 and (slots == 1).all() and (out == 1.0).all()
    dx = ops.scatter_add_slots(torch.ones(1, 8, 4), torch.from_numpy(idx), slots, 8)
    assert dx[0, 5].tolist() == [8.0] * 4 and float(dx.sum()) == 32.0  # all to row 5, slot 1


# ---------------------------------------------------------- Chamfer and EMD


def _clouds(seed, n=512, m=512, b=1):
    return _rand((b, n, 3), seed, 0.5), _rand((b, m, 3), seed + 1, 0.5)


def test_chamfer_and_nn_distance_match_jnp():
    x, y = _clouds(3, 256, 384, b=2)
    got = ops.nn_distance(torch.from_numpy(x), torch.from_numpy(y))
    want = jops.nn_distance(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    cot = _rand((2,), 4)
    got, ggrads = _port_value_and_grad(ops.chamfer, x, y, cot=cot)
    want, wgrads = _jax_value_and_grad(jops.chamfer, x, y, cot=cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_match_cost_matches_jnp():
    """The port's EMD (the fused kernel's plain version with Chamfer off)
    against ops.match_cost and its match-constant custom VJP, at N != M."""
    x, y = _clouds(5, 512, 384)
    cot = np.asarray([1.5], np.float32)
    got, ggrads = _port_value_and_grad(api.match_cost, x, y, cot=cot)
    want, wgrads = _jax_value_and_grad(jops.match_cost, x, y, cot=cot)
    np.testing.assert_allclose(got, want, rtol=5e-4)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_allclose(g, w, atol=5e-3)


@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
def test_chamfer_match_cost_pair_matches_jax(backend, request):
    """(chamfer, emd) from one call against (ops.chamfer, ops.match_cost) and
    against pallas_emd.chamfer_match_cost_tpu: values, the Chamfer min/argmin
    and the gradient of chamfer + 0.5 · emd."""
    x, y = _clouds(7, b=2)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
        from pccf.kernels.pallas_emd import _emd_chamfer_forward, chamfer_match_cost_tpu

        jfn = chamfer_match_cost_tpu
        want_nn = _emd_chamfer_forward(jx, jy)[3:]
    else:
        def jfn(a, b):
            return jops.chamfer(a, b), jops.match_cost(a, b)

        want_nn = jops.nn_distance(jx, jy)

    def jloss(a, b):
        cham, cost = jfn(a, b)
        return jnp.sum(cham) + 0.5 * jnp.sum(cost), (cham, cost)

    (_, (jcham, jcost)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jx, jy)
    pair = [torch.tensor(a, requires_grad=True) for a in (x, y)]
    cham, cost = api.chamfer_match_cost(*pair)
    (torch.sum(cham) + 0.5 * torch.sum(cost)).backward()
    np.testing.assert_allclose(cham.detach().numpy(), np.asarray(jcham), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(jcost), rtol=5e-4)
    for t, w in zip(pair, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-3)
    for g, w in zip(emd.plain(torch.from_numpy(x), torch.from_numpy(y))[3:], want_nn):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# ----------------------------------------------------------- graph filtering


@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
def test_graph_filtering_matches_jax(backend, request):
    """Value and gradient against japi.graph_filtering.  On the jnp path the
    cloud has exact duplicates: kNN slot 0 of the later copies is the
    lowest-index copy, not the point itself, and the port drops the same slot
    as JAX does (the sqrt guard keeps the gradient finite).  The Pallas kNN
    puts the point itself first instead, so its gradient would go to another
    copy: that comparison runs on a cloud without duplicates."""
    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
    x = _rand((2, 256, 3), 11, 0.5)
    if backend == 'jnp':
        x[0, 100] = x[0, 9]
        x[0, 200] = x[0, 9]
        x[1, 17] = x[1, 3]
        idx = api.knn(torch.from_numpy(x), 4).numpy()
        np.testing.assert_array_equal(idx, np.asarray(jops.knn(jnp.asarray(x), 4)))
        assert idx[0, 100, 0] == 9 and idx[0, 200, 0] == 9 and idx[1, 17, 0] == 3
    cot = _rand((2, 256, 3), 12)
    with japi.force_backend(backend):
        want, (wgrad,) = _jax_value_and_grad(japi.graph_filtering, x, cot=cot)
    got, (ggrad,) = _port_value_and_grad(api.graph_filtering, x, cot=cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(ggrad).all()
    np.testing.assert_allclose(ggrad, wgrad, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------- train-mode modules


def _grads_by_name(jax_grads) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in flax_to_state_dict({'params': jax_grads}).items()}


def _assert_grads_close(module: torch.nn.Module, want: dict[str, np.ndarray], rel_l2=1e-4):
    for name, p in module.named_parameters():
        if not p.requires_grad:
            continue
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        scale = np.linalg.norm(want[name])
        err = np.linalg.norm(got - want[name])
        assert err <= rel_l2 * scale + 1e-7, f'{name}: |grad diff| {err:.3e}, |grad| {scale:.3e}'


def _assert_stats_close(module: torch.nn.Module, new_stats, **tol):
    state = module.state_dict()
    for name, v in flax_to_state_dict({'batch_stats': new_stats}).items():
        np.testing.assert_allclose(state[name].numpy(), v.numpy(), err_msg=name, **tol)


@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
def test_edge_conv_train_matches_jax(backend, request):
    """Streaming-BN statistics, output, input and parameter gradients, and
    the updated running statistics of one EdgeConv block in train mode."""
    from pccf.nn.encoders import EdgeConvBlock
    from pccf.nn.layers import default_act
    from pccf_torch.nn.encoders import EdgeConvBlock as TBlock
    from pccf_torch.nn.layers import default_act as tact

    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
    x = _rand((2, 256, 8), 13)
    idx = np.array(jops.knn(jnp.asarray(x), 8))
    cot = _rand((2, 256, 16), 14)
    blk = EdgeConvBlock(16, 8, default_act)
    v = randomize_stats(blk.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(idx)), seed=13)

    def jfn(params, a):
        out, upd = blk.apply({'params': params, 'batch_stats': v['batch_stats']}, a, jnp.asarray(idx), train=True,
                             mutable=['batch_stats'])
        return out, upd['batch_stats']

    with japi.force_backend(backend):
        want, new_stats, (wparams, wx) = _jax_train_vjp(jfn, v['params'], jnp.asarray(x), jnp.asarray(cot))
    port = load_port(TBlock(8, 16, 8, tact), v).train()
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt, torch.from_numpy(idx))
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wx), **FP32)
    _assert_grads_close(port, _grads_by_name(wparams))
    _assert_stats_close(port, new_stats, rtol=1e-5, atol=1e-6)


def _gumbel_patch(monkeypatch, uniform: np.ndarray):
    """Hand the JAX decoder the test's uniform noise: same formula as
    pccf.nn.layers.gumbel_softmax with the draw replaced."""
    import pccf.nn.decoders

    def fake(rng, logits, tau, axis=-1):
        gumbel = -jnp.log(-jnp.log(jnp.asarray(uniform) + 1e-20) + 1e-20)
        return jax.nn.softmax((logits + gumbel) / tau, axis=axis)

    monkeypatch.setattr(pccf.nn.decoders, 'gumbel_softmax', fake)


def test_pcgen_decoder_train_matches_jnp(monkeypatch):
    """Module path in train mode: batch-stat BatchNorm per component, Gumbel
    attention from the same noise, graph filtering; output, gradients of the
    latent and the parameters, updated running statistics."""
    from pccf.nn.decoders import PCGenDecoder
    from pccf_torch.nn.decoders import PCGenDecoder as TDec
    from pccf_torch.nn.layers import relu

    dims = dict(w_dim=64, sample_dim=4, n_components=3, map_dims=(8,), conv_dims=(64, 32, 16), tau=5.0)
    b, n = 2, 256
    w, samp = _rand((b, 64), 15), _rand((b, n, 4), 16)
    uniform = np.random.default_rng(17).uniform(1e-20, 1.0, (b, n, 3)).astype(np.float32)
    cot = _rand((b, n, 3), 18)
    _gumbel_patch(monkeypatch, uniform)
    dec = PCGenDecoder(**dims, act=jax.nn.relu, act_name='ReLU', filtering=True)
    v = randomize_stats(dec.init({'params': jax.random.key(0), 'sampling': jax.random.key(1)}, jnp.asarray(w), n,
                                 jnp.asarray(samp), train=False), seed=15)

    def jfn(params, w_):
        out, upd = dec.apply({'params': params, 'batch_stats': v['batch_stats']}, w_, n, jnp.asarray(samp),
                             train=True, rngs={'sampling': jax.random.key(2)}, mutable=['batch_stats'])
        return out, upd['batch_stats']

    with japi.force_backend('jnp'):
        want, new_stats, (wparams, ww) = _jax_train_vjp(jfn, v['params'], jnp.asarray(w), jnp.asarray(cot))
    port = load_port(TDec(**dims, act=relu, filtering=True), v).train()
    wt = torch.tensor(w, requires_grad=True)
    out = port(wt, torch.from_numpy(samp), torch.from_numpy(uniform))
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ww), **FP32)
    _assert_grads_close(port, _grads_by_name(wparams))
    _assert_stats_close(port, new_stats, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- one training step

N_TRAIN = 256
TRAIN_OVERRIDES = [
    f'data.n_input_points={N_TRAIN}',
    f'data.n_target_points={N_TRAIN}',
    'data.n_neighbors=8',
    'autoencoder.model.w_dim=128',
    'autoencoder.model.book_size=8',
    'autoencoder.model.decoder.map_dims=[8]',
    'autoencoder.model.decoder.conv_dims=[128,64,16]',
    'autoencoder.model.decoder.n_components=2',
    'autoencoder.model.decoder.sample_dim=4',
    'autoencoder.train.batch_size=2',
    'w_autoencoder.model.w_encoder.proj_dim=32',
    'w_autoencoder.model.w_encoder.n_heads=2',
    'w_autoencoder.model.w_encoder.mlp_dims=[32]',
    'w_autoencoder.model.w_decoder.proj_dim=32',
    'w_autoencoder.model.w_decoder.n_heads=2',
    'w_autoencoder.model.w_decoder.mlp_dims=[32]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=32',
    'w_autoencoder.model.conditional_w_encoder.n_heads=2',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[32]',
    'w_autoencoder.model.z1_dim=4',
    'w_autoencoder.model.z2_dim=4',
]
STEPS_PER_EPOCH = 3


def _port_train_config(recon_loss='ChamferEMD'):
    from pccf_torch import config as tc

    net = tc.TransformerNetConfig
    return tc.SliceConfig(
        data=tc.DataConfig(n_input_points=N_TRAIN, n_target_points=N_TRAIN, n_neighbors=8, n_classes=2),
        autoencoder=tc.AutoEncoderConfig(
            book_size=8, embedding_dim=4, w_dim=128,
            decoder=tc.DecoderConfig(sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(128, 64, 16)),
            train=tc.AutoEncoderTrainConfig(batch_size=2, recon_loss=recon_loss),
        ),
        w_autoencoder=tc.WAutoEncoderConfig(z1_dim=4, z2_dim=4, w_encoder=net(32, 2, (32,)),
                                            w_decoder=net(32, 2, (32,)), conditional_w_encoder=net(32, 2, (32,))),
    )


def _jax_train_step(cfg, v, inputs, targets):
    """runners.py:298-322 on the jnp path, returning the gradients too: the
    optimiser is the JAX Trainer's own (AdamW, epoch-resolution cosine
    schedule, frozen w_autoencoder)."""
    import optax
    from pccf.dist import get_mesh
    from pccf.models import get_autoencoder
    from pccf.train import Model, Trainer, get_autoencoder_loss, get_learning_schema

    module = get_autoencoder(cfg)
    objective = get_autoencoder_loss(cfg)
    loader = types.SimpleNamespace(batch_size=2, n_batches=lambda inference=False: STEPS_PER_EPOCH)
    trainer = Trainer(Model(module, 'vqvae', variables=v), loader, objective, get_learning_schema(cfg.autoencoder),
                      frozen=('w_autoencoder',), mesh=get_mesh(1))
    tx = trainer._make_tx()

    @jax.jit
    def step(params, batch_stats, inputs, targets):
        def loss_fn(p):
            outputs, updates = module.apply({'params': p, 'batch_stats': batch_stats}, inputs, train=True,
                                            rngs={'sampling': jax.random.key(5)}, mutable=['batch_stats'])
            loss, metrics = objective.loss_and_metrics(outputs, targets)
            return loss, (updates['batch_stats'], metrics)

        (_, (new_stats, metrics)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return metrics, grads, new_stats, optax.apply_updates(params, updates)

    with japi.force_backend('jnp'):
        return step(v['params'], v['batch_stats'], inputs, targets)


def test_train_step_matches_jax(monkeypatch):
    """One stage-1 step of a small flagship-shaped VQ-VAE (filter on,
    ChamferEMD + 8 · embedding loss, AdamW at lr 0.004 with decay 0.001) from
    the same flax weights, batch, decoder sampling and Gumbel noise: losses,
    every parameter's gradient, the updated BatchNorm statistics, and the
    parameters after AdamW; the frozen inner CVAE does not move."""
    check_train_step(monkeypatch, 'ChamferEMD', {'Chamfer', 'EMD', 'Embed. Loss', 'Loss'})


JAX_OBJECTIVES = {'ChamferEMD': 'chamfer_emd', 'Chamfer': 'chamfer', 'ChamferSinkhorn': 'chamfer_sinkhorn'}


def check_train_step(monkeypatch, recon_loss: str, metric_names: set[str]) -> None:
    """One step of the port against the JAX train step under the
    reconstruction objective ``recon_loss``, which reports ``metric_names``."""
    from pccf.config import get_config_all
    from pccf.data.structures import Inputs as JInputs, Targets as JTargets
    from pccf.models import get_autoencoder
    from pccf_torch.data.structures import Inputs, Targets
    from pccf_torch.models import build_vqvae
    from pccf_torch.train import Trainer, get_autoencoder_loss

    cfg = get_config_all(TRAIN_OVERRIDES + [f'autoencoder/objective={JAX_OBJECTIVES[recon_loss]}'])
    assert cfg.autoencoder.objective.recon_loss == recon_loss
    rng = np.random.default_rng(19)
    cloud = (rng.standard_normal((2, N_TRAIN, 3)) / 2).astype(np.float32)
    ref = (cloud + rng.standard_normal(cloud.shape) * 0.01).astype(np.float32)
    sampling = rng.standard_normal((2, N_TRAIN, 4)).astype(np.float32)
    uniform = rng.uniform(1e-20, 1.0, (2, N_TRAIN, 2)).astype(np.float32)
    _gumbel_patch(monkeypatch, uniform)

    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    v = init({'params': jax.random.key(2), 'sampling': jax.random.key(3)}, JInputs(cloud=jnp.asarray(cloud)),
             jnp.zeros((2, 2)))
    v = randomize_stats(v, seed=19)
    metrics, grads, new_stats, new_params = _jax_train_step(
        cfg, v, JInputs(cloud=jnp.asarray(cloud), initial_sampling=jnp.asarray(sampling)),
        JTargets(ref_cloud=jnp.asarray(ref)))

    pcfg = _port_train_config(recon_loss)
    port = load_port(build_vqvae(pcfg), v)
    frozen_before = {k: p.detach().clone() for k, p in port.w_autoencoder.named_parameters()}
    trainer = Trainer(port, get_autoencoder_loss(pcfg), pcfg.autoencoder.train, STEPS_PER_EPOCH)
    assert trainer.lr_at(0) == 0.004
    got = trainer.run_step(Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)),
                           Targets(torch.from_numpy(ref)), torch.from_numpy(uniform))

    assert set(got) == set(metrics) == metric_names
    for name, value in metrics.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=1e-4, err_msg=name)
    want_grads = _grads_by_name(grads)
    _assert_grads_close(port, want_grads)
    _assert_stats_close(port, new_stats, rtol=1e-4, atol=1e-6)
    after = port.state_dict()
    for name, want in flax_to_state_dict({'params': new_params}).items():
        if name.startswith('w_autoencoder.'):
            continue
        live = np.abs(want_grads[name]) > 1e-5
        np.testing.assert_allclose(after[name].numpy()[live], want.numpy()[live], rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(after[name].numpy() - want.numpy()).max() <= 2 * 0.004 + 1e-6, name
    for name, p in port.w_autoencoder.named_parameters():
        assert torch.equal(p, frozen_before[name]), name


def test_schedule_matches_jax():
    """The flagship cosine schedule with restarts, and a warmup, per epoch."""
    from pccf.train.schedulers import cosine_scheduler, restart as jrestart, warmup as jwarmup
    from pccf_torch.config import SchedulerConfig
    from pccf_torch.train.schedulers import get_scheduler

    for cfg in (SchedulerConfig(), SchedulerConfig(warmup_steps=5, restart_fraction=0.5)):
        want = jwarmup(jrestart(cosine_scheduler(cfg.min_decay, cfg.decay_steps), cfg.restart_interval,
                                cfg.restart_fraction), cfg.warmup_steps)
        got = get_scheduler(cfg)
        for epoch in range(0, 301, 7):
            assert got(epoch) == pytest.approx(want(epoch), rel=1e-12), epoch


def test_chamfer_and_emd_terms_share_one_call(monkeypatch):
    from pccf_torch.data.structures import Outputs, Targets
    from pccf_torch.train import get_autoencoder_loss
    from pccf_torch.config import SliceConfig

    calls = []
    real = api.chamfer_match_cost
    monkeypatch.setattr(api, 'chamfer_match_cost', lambda *a, **k: calls.append(1) or real(*a, **k))
    x, y = (torch.from_numpy(a) for a in _clouds(21, 64, 64, b=2))
    w_q, w_e = torch.from_numpy(_rand((2, 16), 22)), torch.from_numpy(_rand((2, 16), 23))
    loss, metrics = get_autoencoder_loss(SliceConfig()).loss_and_metrics(
        Outputs(recon=x, w_q=w_q, w_e=w_e), Targets(ref_cloud=y))
    assert len(calls) == 1
    cham, cost = real(x, y)
    embed = torch.mean((w_q - w_e) ** 2, dim=1)
    torch.testing.assert_close(loss, torch.mean(cham + cost + 8.0 * embed))
    torch.testing.assert_close(metrics['Embed. Loss'], torch.mean(embed))


def test_objective_algebra_matches_jax():
    """``+`` sums per-sample terms, a number scales one, ``|`` reports a
    metric without optimising it, and one name bound to two calculations
    raises."""
    from pccf.train.objectives import Loss as JLoss, Metric as JMetric
    from pccf_torch.train import Loss

    values = {name: _rand((3,), seed) for seed, name in enumerate('abm', 31)}

    def calc(name, wrap):
        return lambda outputs, targets: wrap(values[name])

    got_loss, got = ((Loss(calc('a', torch.from_numpy), 'a') + 2 * Loss(calc('b', torch.from_numpy), 'b'))
                     | Loss(calc('m', torch.from_numpy), 'm')).loss_and_metrics(None, None)
    want_loss, want = ((JLoss(calc('a', jnp.asarray), 'a') + 2 * JLoss(calc('b', jnp.asarray), 'b'))
                       | JMetric(calc('m', jnp.asarray), 'm')).loss_and_metrics(None, None)
    assert set(got) == set(want) == {'a', 'b', 'm', 'Loss'}
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(got_loss), np.mean(values['a'] + 2 * values['b']), rtol=1e-6)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match='collision'):
        Loss(calc('a', torch.from_numpy), 'a') + Loss(calc('b', torch.from_numpy), 'a')


def test_synthetic_clouds_match_the_jax_package():
    from pccf.data.augmentations import normalise
    from pccf.data.synthetic import _shape_cloud
    from pccf_torch.data import synthetic

    got = synthetic.batch(seed=3, size=6, n_points=300)
    rng = np.random.default_rng(3)
    want = np.stack([normalise(_shape_cloud(rng, i, 300))[0] for i in range(6)]).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_straight_through_and_one_hot_match_jax():
    """Forward w_e, the whole gradient to w_q and none to w_e
    (ops.py:485-501); one-hot selections as float32."""
    w_e, w_q, cot = _rand((2, 16), 24), _rand((2, 16), 25), _rand((2, 16), 26)
    got, ggrads = _port_value_and_grad(ops.straight_through, w_e, w_q, cot=cot)
    want, wgrads = _jax_value_and_grad(jops.straight_through, w_e, w_q, cot=cot)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ggrads[1], cot)
    idx = np.random.default_rng(27).integers(0, 8, (2, 4)).astype(np.int32)
    one_hot = ops.one_hot_idx(torch.from_numpy(idx), 8)
    assert one_hot.dtype == torch.float32
    np.testing.assert_array_equal(one_hot.numpy(), np.asarray(jops.one_hot_idx(jnp.asarray(idx), 8)))


@pytest.mark.parametrize('groups', [1, 4])
def test_dense_block_train_matches_flax(groups):
    """Batch-stat BatchNorm in a DenseBlock: output, input and parameter
    gradients, and the running statistics moved with the biased variance."""
    from pccf.nn.layers import DenseBlock, default_act
    from pccf_torch.nn.layers import DenseBlock as TDenseBlock, default_act as tact

    x = _rand((3, 40, 16), 28 + groups)
    cot = _rand((3, 40, 24), 29)
    blk = DenseBlock(24, act=default_act, groups=groups, residual=True)
    v = randomize_stats(blk.init(jax.random.key(0), jnp.asarray(x)), seed=30)

    def jfn(params, a):
        out, upd = blk.apply({'params': params, 'batch_stats': v['batch_stats']}, a, True, mutable=['batch_stats'])
        return out, upd['batch_stats']

    want, new_stats, (wparams, wx) = _jax_train_vjp(jfn, v['params'], jnp.asarray(x), jnp.asarray(cot))
    port = load_port(TDenseBlock(16, 24, act=tact, groups=groups, residual=True), v).train()
    got, (gx,) = _port_value_and_grad(port, x, cot=cot)
    np.testing.assert_allclose(got, np.asarray(want), **FP32)
    np.testing.assert_allclose(gx, np.asarray(wx), **FP32)
    _assert_grads_close(port, _grads_by_name(wparams))
    _assert_stats_close(port, new_stats, rtol=1e-5, atol=1e-6)

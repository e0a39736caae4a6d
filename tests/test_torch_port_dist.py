"""Data parallelism of pccf_torch against the JAX package, on the CPU.

BatchNorm's statistic groups (``PCCF_BN_GROUPS``) in ``BatchNorm`` (plain and
stacked), the EdgeConv in both forms and ``DenseBlock`` against JAX's
``GroupedBatchNorm`` and grouped EdgeConv in process, as
``tests/test_bn_groups.py`` holds them, and G = 1 equal to the ungrouped
formula; the moments function with one rank (no collective).  Then one spawn
of two gloo ranks takes a stage-1 step (Chamfer), a stage-2 step and a
classifier step at G = 1, 2 and 4 (4 on 2 ranks: a rank holds two groups),
each held against JAX's step on ``get_mesh(2)`` of the conftest's virtual
devices from the same flax weights, global batch and noise: losses, every
gradient, the BatchNorm statistics and the parameters after the optimiser;
the stage-1 step taken twice is bit-equal and the ranks end bit-equal; the
classifier with dropout equals the one-rank port.  The same spawn runs the
codebook hook (both ranks install rank 0's rewrite, bit-equal to
``pccf/train/hooks.py``'s) and a stage-1 ``fit`` with early stopping (both
ranks stop at the same epoch) and checkpoints (rank 0 alone writes).  The
launcher, the configuration and the server are in
tests/test_torch_port_dist_entry.py.

Tolerances: the grouped statistics 1e-5 (outputs) and 1e-6 (running
statistics), as tests/test_bn_groups.py and tests/test_torch_port_train.py
hold the ungrouped ones, gradients rel-L2 1e-4; the steps at
tests/test_torch_port_stage1.py's, tests/test_torch_port_stage2.py's and
tests/test_torch_port_classifier.py's tolerances; two ranks against one rank
of the port at the same ones (the sums add in another order).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs, Targets as JTargets
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.structures import Inputs, Targets, WInputs, WTargets
from pccf_torch.dist import launch, mesh

from pccf_torch.models import build_vqvae

from tests import torch_dist_ranks as ranks
from tests.test_torch_port_modules import load_port, randomize_stats

torch.set_num_threads(1)

GROUPS = (1, 2, 4)
FP32 = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(np.asarray(b)) + 1e-30))


# ------------------------------------------------------- grouped statistics


def _jax_bn(groups):
    from flax import linen as fnn
    from pccf.nn.layers import GroupedBatchNorm

    return GroupedBatchNorm(groups=groups) if groups > 1 else fnn.BatchNorm(momentum=0.9, epsilon=1e-5)


@pytest.mark.parametrize('groups', [1, 2])
@pytest.mark.parametrize('stacked', [False, True])
def test_batch_norm_groups_match_jax(monkeypatch, groups, stacked):
    """Outputs, input and scale gradients and running statistics of the
    port's BatchNorm at ``PCCF_BN_GROUPS`` against flax's BatchNorm (G = 1)
    and ``GroupedBatchNorm`` (G = 2); stacked, each of 3 stack entries (the
    vmapped PCGen components) against its own."""
    from pccf_torch.nn.layers import BatchNorm

    monkeypatch.setenv('PCCF_BN_GROUPS', str(groups))
    stack = 3 if stacked else 1
    x = _rand((stack, 8, 16, 6), 1)
    cot = _rand((stack, 8, 16, 6), 2)
    rng = np.random.default_rng(3)
    scale, bias = rng.uniform(0.5, 1.5, (stack, 6)).astype(np.float32), _rand((stack, 6), 4)
    ra_mean, ra_var = _rand((stack, 6), 5, 0.1), rng.uniform(0.5, 2.0, (stack, 6)).astype(np.float32)
    port = BatchNorm(stack, 6) if stacked else BatchNorm(6)
    with torch.no_grad():
        for name, v in (('weight', scale), ('bias', bias), ('running_mean', ra_mean), ('running_var', ra_var)):
            getattr(port, name).copy_(torch.from_numpy(v if stacked else v[0]))
    xt = torch.tensor(x if stacked else x[0], requires_grad=True)
    y = port.train()(xt)
    torch.sum(y * torch.from_numpy(cot if stacked else cot[0])).backward()
    for s in range(stack):
        bn = _jax_bn(groups)
        v = {'params': {'scale': scale[s], 'bias': bias[s]}, 'batch_stats': {'mean': ra_mean[s], 'var': ra_var[s]}}

        def fn(params, a):
            out, upd = bn.apply({'params': params, 'batch_stats': v['batch_stats']}, a, use_running_average=False,
                                mutable=['batch_stats'])
            return out, upd['batch_stats']

        (want, stats), vjp = jax.vjp(fn, v['params'], jnp.asarray(x[s]))
        gparams, gx = vjp((jnp.asarray(cot[s]), jax.tree.map(jnp.zeros_like, stats)))
        got = (lambda t: t[s] if stacked else t)
        np.testing.assert_allclose(got(y.detach()).numpy(), np.asarray(want), **FP32)
        np.testing.assert_allclose(got(xt.grad).numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
        assert _rel_l2(got(port.weight.grad).numpy(), gparams['scale']) <= 1e-4
        np.testing.assert_allclose(got(port.running_mean).numpy(), np.asarray(stats['mean']), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got(port.running_var).numpy(), np.asarray(stats['var']), rtol=1e-5, atol=1e-6)


def _edge_pair(act_name, seed):
    from pccf.nn.encoders import EdgeConvBlock
    from pccf.nn.layers import default_act, gelu_exact
    from pccf_torch.nn.encoders import EdgeConvBlock as TBlock
    from pccf_torch.nn.layers import get_act

    x = _rand((4, 64, 8), seed, 0.5)
    blk = EdgeConvBlock(16, 6, {'': default_act, 'GELU': gelu_exact}[act_name])
    v = randomize_stats(blk.init(jax.random.key(seed), jnp.asarray(x), None), seed=seed)
    return x, blk, v, load_port(TBlock(8, 16, 6, get_act(act_name)), v)


@pytest.mark.parametrize('act_name', ['', 'GELU'], ids=['streaming', 'materialised'])
def test_edge_conv_groups_match_jax(monkeypatch, act_name):
    """``PCCF_BN_GROUPS=2`` in both EdgeConv forms against JAX's grouped
    EdgeConv (``encoders.py:89-140``): output, input and parameter
    gradients, running statistics; the streaming form's five terms reduce
    in one moments call."""
    from tests.test_torch_port_train import _assert_grads_close, _assert_stats_close, _grads_by_name, _jax_train_vjp

    monkeypatch.setenv('PCCF_BN_GROUPS', '2')
    x, blk, v, port = _edge_pair(act_name, 11)
    cot = _rand((4, 64, 16), 12)

    def jfn(params, a):
        out, upd = blk.apply({'params': params, 'batch_stats': v['batch_stats']}, a, None, train=True,
                             mutable=['batch_stats'])
        return out, upd['batch_stats']

    calls = []
    real = mesh.group_moments
    monkeypatch.setattr(mesh, 'group_moments', lambda terms, *a: calls.append(len(terms)) or real(terms, *a))
    with japi.force_backend('jnp'):
        want, new_stats, (wparams, wx) = _jax_train_vjp(jfn, v['params'], jnp.asarray(x), jnp.asarray(cot))
    xt = torch.tensor(x, requires_grad=True)
    out = port.train()(xt)
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert calls == [5 if act_name == '' else 2]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-4)
    _assert_grads_close(port, _grads_by_name(wparams))
    _assert_stats_close(port, new_stats, rtol=1e-5, atol=1e-6)


def test_dense_block_groups_match_jax(monkeypatch):
    """A DenseBlock at ``PCCF_BN_GROUPS=2`` against JAX's, whose BatchNorm is
    then ``GroupedBatchNorm`` under the same variable names."""
    from pccf.nn.layers import DenseBlock, default_act
    from pccf_torch.nn.layers import DenseBlock as TBlock, default_act as tact

    from tests.test_torch_port_train import _assert_stats_close

    x = _rand((4, 16, 6), 21)
    blk = DenseBlock(features=8, act=default_act)
    v = randomize_stats(blk.init(jax.random.key(1), jnp.asarray(x), train=False), seed=21)
    monkeypatch.setenv('PCCF_BN_GROUPS', '2')
    want, upd = blk.apply(v, jnp.asarray(x), train=True, mutable=['batch_stats'])
    port = load_port(TBlock(6, 8, act=tact), v).train()
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **FP32)
    _assert_stats_close(port, upd['batch_stats'], rtol=1e-5, atol=1e-6)


def test_one_group_is_the_ungrouped_formula(monkeypatch):
    """At G = 1 (unset or ``'1'``) BatchNorm and the streaming EdgeConv give
    bit for bit the ungrouped statistics, the batch mean and the clamped
    biased variance over every axis but the features, and bit for bit its
    gradients: a one-process step builds its graph in the ungrouped order,
    so autograd sums each tensor's gradients in the same order."""
    from pccf_torch.kernels import api
    from pccf_torch.nn.layers import BatchNorm

    cot = torch.from_numpy(_rand((4, 16, 6), 30))
    for setting in (None, '1'):
        if setting is None:
            monkeypatch.delenv('PCCF_BN_GROUPS', raising=False)
        else:
            monkeypatch.setenv('PCCF_BN_GROUPS', setting)
        bn = BatchNorm(6).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        x, xr = (torch.from_numpy(_rand((4, 16, 6), 31)).requires_grad_() for _ in range(2))
        y = bn(x)
        (y * cot).sum().backward()
        mean = torch.mean(xr, dim=(0, 1))
        var = torch.clamp_min(torch.mean(xr * xr, dim=(0, 1)) - mean * mean, 0.0)
        want = (xr - mean) * (bn.weight * torch.rsqrt(var + bn.eps)) + bn.bias
        (want * cot).sum().backward()
        assert torch.equal(y, want) and torch.equal(x.grad, xr.grad)
        assert torch.equal(bn.running_mean, 0.1 * mean) and torch.equal(bn.running_var, 0.9 + 0.1 * var)

        _, _, _, port = _edge_pair('', 32)
        port.train()
        idx = api.knn(torch.from_numpy(_rand((4, 64, 8), 35)), 6)
        grads = []
        for ungrouped in (False, True):
            u, s = torch.from_numpy(_rand((4, 64, 16), 33)).requires_grad_(), \
                torch.from_numpy(_rand((4, 64, 16), 34)).requires_grad_()
            if ungrouped:
                sums = api.graph_sum_pool(torch.cat([u, u * u], dim=-1), idx)
                usum, u2sum = sums[..., :16], sums[..., 16:]

                def m(t):
                    return torch.mean(t, dim=(0, 1))

                bmean = m(usum) / 6 + m(s)
                bvar = m(u2sum) / 6 + 2.0 * (m(s * usum) / 6) + m(s * s) - bmean * bmean
                a = port.bn.weight * torch.rsqrt(bvar + port.bn.eps)
                b = port.bn.bias - bmean * a
            else:
                a, b = port._batch_affine(u, s, idx)
            out = (u * a + s * a + b).sum(dim=1)
            (out * torch.arange(16.0)).sum().backward()
            grads.append((a.detach(), b.detach(), u.grad, s.grad))
        assert all(torch.equal(g, w) for g, w in zip(*grads))


def test_indivisible_groups_raise(monkeypatch):
    """A batch that G does not divide raises, as ``layers.py:71-72`` does."""
    from pccf_torch.nn.layers import BatchNorm

    monkeypatch.setenv('PCCF_BN_GROUPS', '4')
    with pytest.raises(ValueError, match='batch 6 not divisible by bn groups 4'):
        BatchNorm(3).train()(torch.zeros((6, 5, 3)))
    _, _, _, port = _edge_pair('', 36)
    with pytest.raises(ValueError, match='not divisible by bn groups'):
        port.train()(torch.from_numpy(_rand((6, 64, 8), 37)))


def test_moments_with_one_rank_run_no_collective(monkeypatch):
    """Outside a process group of two or more nothing calls a collective:
    the moments equal ``torch.mean`` (G = 1) and the per-group mean (G = 2),
    the draw is the draw, gradients and metrics are left as they are and the
    broadcast returns its value."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError('a collective ran in one process')

    monkeypatch.setattr(dist, 'all_reduce', refuse)
    monkeypatch.setattr(dist, 'broadcast', refuse)
    x = torch.from_numpy(_rand((4, 8, 3), 41))
    with mesh.sharded(4) as shard:
        assert shard is None
        (m1,) = mesh.group_moments([x], 1)
        (m2,) = mesh.group_moments([x], 2)
        draw = mesh.draw(lambda s: torch.arange(float(np.prod(s))).reshape(s), (4, 2))
    assert torch.equal(m1[0], torch.mean(x, dim=(0, 1)))
    assert torch.equal(m2, torch.mean(x.reshape(2, 2, 8, 3), dim=(1, 2)))
    assert torch.equal(mesh.expand_groups(m2, 4, 2), m2.repeat_interleave(2, dim=0))
    assert torch.equal(draw, torch.arange(8.0).reshape(4, 2))
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    assert mesh.average_gradients([p]) == 0 and torch.equal(p.grad, torch.full((3,), 2.0))
    metrics = {'a': torch.tensor(1.0)}
    assert mesh.reduce_metrics(None, metrics, None, None) is metrics
    assert torch.equal(mesh.broadcast_from_main(x, x), x) and mesh.broadcast_from_main(None, x) is None
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main_process()


def test_shard_batch_takes_contiguous_slices(monkeypatch):
    """Rank r's rows ``[r · B/n, (r + 1) · B/n)`` of every field; a batch the
    ranks do not divide raises."""
    monkeypatch.setattr(mesh, 'world_size', lambda: 2)
    monkeypatch.setattr(mesh, 'rank', lambda: 1)
    x = torch.arange(12.0).reshape(6, 2)
    got = mesh.shard_batch((Inputs(x, None, x + 1), None, (x, x * 2)))
    assert torch.equal(got[0].cloud, x[3:]) and got[0].indices is None
    assert torch.equal(got[0].initial_sampling, x[3:] + 1)
    assert got[1] is None and torch.equal(got[2][1], x[3:] * 2)
    with pytest.raises(ValueError, match='not divisible by the 2-rank'):
        mesh.shard_batch(Inputs(torch.zeros((3, 2))))


# ------------------------------------------------------------ two gloo ranks

N_POINTS = 128  # stage 1's clouds
# global batches: at G = 4 a stage-1 group is one cloud, a classifier group
# four (the head's BatchNorm over two samples is ill-conditioned in float32)
AE_BATCH, W_BATCH, CLS_BATCH = 4, 4, 16
AE_OVERRIDES = [f'data.n_input_points={N_POINTS}', f'data.n_target_points={N_POINTS}', 'data.n_neighbors=8',
                'autoencoder.model.w_dim=128', 'autoencoder.model.book_size=8',
                'autoencoder.model.decoder.map_dims=[8]', 'autoencoder.model.decoder.conv_dims=[128,64,16]',
                'autoencoder.model.decoder.n_components=2', 'autoencoder.model.decoder.sample_dim=4',
                f'autoencoder.train.batch_size={AE_BATCH}', 'w_autoencoder.model.w_encoder.proj_dim=32',
                'w_autoencoder.model.w_encoder.n_heads=2', 'w_autoencoder.model.w_encoder.mlp_dims=[32]',
                'w_autoencoder.model.w_decoder.proj_dim=32', 'w_autoencoder.model.w_decoder.n_heads=2',
                'w_autoencoder.model.w_decoder.mlp_dims=[32]', 'w_autoencoder.model.conditional_w_encoder.proj_dim=32',
                'w_autoencoder.model.conditional_w_encoder.n_heads=2',
                'w_autoencoder.model.conditional_w_encoder.mlp_dims=[32]', 'w_autoencoder.model.z1_dim=4',
                'w_autoencoder.model.z2_dim=4', 'autoencoder/objective=chamfer']
STEPS_PER_EPOCH = 3
# the classifier's final_conv BatchNorm shift moves every point's feature, so
# the max, by the same amount, which the head's BatchNorm takes out again: its
# gradient is zero but for rounding
ZERO_GRADIENT = 'final_conv.bn.bias'
CODEBOOK = dict(n_codes=6, book=8, dim=4, final=5)
FIT_EPOCHS = 6


def _ae_port_config():
    net = tc.TransformerNetConfig
    return tc.SliceConfig(
        data=tc.DataConfig(n_input_points=N_POINTS, n_target_points=N_POINTS, n_neighbors=8, n_classes=2),
        autoencoder=tc.AutoEncoderConfig(
            book_size=8, embedding_dim=4, w_dim=128,
            decoder=tc.DecoderConfig(sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(128, 64, 16)),
            train=tc.AutoEncoderTrainConfig(batch_size=AE_BATCH, recon_loss='Chamfer')),
        w_autoencoder=tc.WAutoEncoderConfig(z1_dim=4, z2_dim=4, w_encoder=net(32, 2, (32,)),
                                            w_decoder=net(32, 2, (32,)), conditional_w_encoder=net(32, 2, (32,))))


def _stage1():
    """The flax VQ-VAE's variables, the global batch and its noise."""
    from pccf.models import get_autoencoder

    cfg = get_config_all(AE_OVERRIDES)
    rng = np.random.default_rng(19)
    cloud = (rng.standard_normal((AE_BATCH, N_POINTS, 3)) / 2).astype(np.float32)
    ref = (cloud + rng.standard_normal(cloud.shape) * 0.01).astype(np.float32)
    sampling = rng.standard_normal((AE_BATCH, N_POINTS, 4)).astype(np.float32)
    uniform = rng.uniform(1e-20, 1.0, (AE_BATCH, N_POINTS, 2)).astype(np.float32)
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    v = init({'params': jax.random.key(2), 'sampling': jax.random.key(3)}, JInputs(cloud=jnp.asarray(cloud[:2])),
             jnp.zeros((2, 2)))
    return cfg, randomize_stats(v, seed=19), (cloud, ref, sampling, uniform)


def _stage2():
    from tests.test_torch_port_stage2 import W_OVERRIDES, _jax_shell, _w_batch

    cfg = get_config_all(W_OVERRIDES)  # its batch is W_BATCH
    shell, v = _jax_shell(cfg, seed=3)
    batch = _w_batch(W_BATCH, 100)
    gen = torch.Generator().manual_seed(7)
    eps = tuple(torch.randn((W_BATCH, 128, 4), generator=gen) for _ in range(2))
    return cfg, shell, v, batch, eps


def _classifier():
    from tests.test_torch_port_classifier import OVERRIDES, _clouds, _jax_pair

    cfg = get_config_all(OVERRIDES[:-1] + [f'classifier.train.batch_size={CLS_BATCH}'])
    cls, v, port = _jax_pair(6)
    cloud, labels = _clouds(CLS_BATCH, 20), np.random.default_rng(20).integers(0, 3, CLS_BATCH)
    return cfg, cls, v, port, (cloud, labels)


# the VampPrior's pseudo-inputs follow the batch's rows on every rank: through
# the convolutional W-encoder's BatchNorm (at G = 2 a group spans the ranks
# and the pseudo-inputs) and through the transformer W-encoder's dropout
VAMP_CASES = (('vamp_conv', 1), ('vamp_conv', 2), ('vamp_dropout', 1))
N_PSEUDO = 2


def _vamp_config(name):
    from tests.test_torch_port_stage2 import w_port_config

    cfg = w_port_config()
    wae = cfg.w_autoencoder
    enc = tc.TransformerNetConfig(class_name='Convolutional', conv_dims=(16, 32), mlp_dims=(),
                                  dropout_rates=(0.0, 0.0), act_name='') if name == 'vamp_conv' else \
        dataclasses.replace(wae.w_encoder, dropout_rates=(0.1,))
    return dataclasses.replace(cfg, w_autoencoder=dataclasses.replace(wae, w_encoder=enc, n_pseudo_inputs=N_PSEUDO))


def _vamp_state(cfg):
    from pccf_torch.models import WAETrainModule, build_w_autoencoder
    from pccf_torch.nn.layers import init_from_seed

    model = WAETrainModule(build_w_autoencoder(cfg), cfg.autoencoder.book_size)
    init_from_seed(model, 9)
    return model.state_dict()


def _codebook_case():
    rng = np.random.default_rng(7)
    c = CODEBOOK
    codebook = rng.standard_normal((c['n_codes'], c['book'], c['dim'])).astype(np.float32)
    idx = rng.integers(0, 5, (10, c['n_codes']))  # entries 5-7 are never chosen
    idx[:, 2] = 3
    one_hot = np.eye(c['book'], dtype=np.float32)[idx]
    return codebook, one_hot


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    """One spawn of two gloo ranks over every case; the cases and each
    rank's results."""
    from tests.test_torch_port_classifier import port_config as cls_port_config
    from tests.test_torch_port_stage2 import _port_shell, w_port_config

    out = tmp_path_factory.mktemp('dp')
    _, v1, (cloud, ref, sampling, uniform) = _stage1()
    ae_state = load_port(build_vqvae(_ae_port_config()), v1).state_dict()
    ae_batch = (Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)),
                Targets(torch.from_numpy(ref)), torch.from_numpy(uniform))
    _, _, v2, ((w_q, logits), (w_e, one_hot, _)), eps = _stage2()
    w_batch = (WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
               WTargets(torch.from_numpy(w_e), torch.from_numpy(one_hot)), eps)
    _, _, _, cport, (ccloud, labels) = _classifier()
    c_batch = (Inputs(torch.from_numpy(ccloud)), Targets(torch.from_numpy(ccloud), torch.from_numpy(labels)), None)
    cases = {}
    for g in GROUPS:
        cases[('vqvae', g)] = dict(kind='vqvae', config=_ae_port_config(), state=ae_state, groups=g,
                                   steps_per_epoch=STEPS_PER_EPOCH, seed=0, batches=[ae_batch],
                                   repeat=2 if g == 1 else 1)
        cases[('wae', g)] = dict(kind='wae', config=w_port_config(), state=_port_shell(v2).state_dict(), groups=g,
                                 steps_per_epoch=2, seed=7, batches=[w_batch])
        cases[('classifier', g)] = dict(kind='classifier', config=cls_port_config(), state=cport.state_dict(),
                                        groups=g, steps_per_epoch=2, seed=7, batches=[c_batch])
    cases[('dropout', 1)] = dict(cases[('classifier', 1)], config=cls_port_config(dropout=(0.5, 0.5)),
                                 batches=[c_batch, c_batch])
    drawn = (w_batch[0], w_batch[1], None)  # the posterior noise drawn by the trainer
    for name, groups in VAMP_CASES:
        vcfg = _vamp_config(name)
        cases[(name, groups)] = dict(kind='wae', config=vcfg, state=_vamp_state(vcfg), groups=groups,
                                     steps_per_epoch=2, seed=7, batches=[drawn])
    torch.save(list(cases.values()), out / 'steps.pt')

    from tests.test_pipeline import TINY
    from pccf_torch import cli

    codebook, one_hot = _codebook_case()
    tiny = cli.get_config([*TINY, 'user.cpu=true'])[0]
    stop = dataclasses.replace(tiny.autoencoder.train, learning_rate=0.05,
                               early_stopping=tc.EarlyStoppingConfig(active=True, window=1, patience=1))
    tiny = dataclasses.replace(tiny, variation='dp_fit', autoencoder=dataclasses.replace(tiny.autoencoder, train=stop))
    hook = dict(codebook=codebook, usage=one_hot.sum(axis=0).astype(np.int64), vq_noise=2.0, final=CODEBOOK['final'],
                config=tiny, train=torch.from_numpy(_rand((8, 64, 3), 51, 0.5)),
                test=torch.from_numpy(_rand((4, 64, 3), 52, 0.5)), exp_dir=str(out / 'exp'), n_epochs=FIT_EPOCHS)
    torch.save(hook, out / 'hook.pt')
    launch(ranks.run_all, 2, 'gloo', str(out / 'steps.pt'), str(out / 'hook.pt'), str(out))
    results = [torch.load(out / f'rank{r}.pt', weights_only=False) for r in range(2)]
    hooks = [torch.load(out / f'hook{r}.pt', weights_only=False) for r in range(2)]
    return {'cases': cases, 'steps': dict(zip(cases, zip(*results))), 'hooks': hooks, 'dir': out}


def _ranks_equal(spawned, key):
    (a,), (b,) = ([r[0]] for r in spawned['steps'][key])
    for name in a['state']:
        assert torch.equal(a['state'][name], b['state'][name]), (key, name)
    assert a['metrics'] == b['metrics']
    return a


def _jax_stage1_step(monkeypatch, groups):
    from pccf.dist import get_mesh, shard_batch
    from tests.test_torch_port_train import _gumbel_patch, _jax_train_step

    cfg, v, (cloud, ref, sampling, uniform) = _stage1()
    _gumbel_patch(monkeypatch, uniform)
    monkeypatch.setenv('PCCF_BN_GROUPS', str(groups))
    m = get_mesh(2)
    inputs = shard_batch(JInputs(cloud=cloud, initial_sampling=sampling), m, strict=True)
    return _jax_train_step(cfg, v, inputs, shard_batch(JTargets(ref_cloud=ref), m, strict=True))


@pytest.mark.parametrize('groups', GROUPS)
def test_stage1_two_ranks_match_jax_mesh(spawned, monkeypatch, groups):
    """A Chamfer step (8 · embedding loss, AdamW) on two gloo ranks against
    JAX's step on a 2-device mesh: losses, every gradient, the BatchNorm
    statistics and the parameters after AdamW; the ranks end bit-equal; the
    frozen inner CVAE does not move; the all-reduce carries every trained
    gradient once."""
    from tests.test_torch_port_train import _grads_by_name

    got = _ranks_equal(spawned, ('vqvae', groups))
    metrics, grads, new_stats, new_params = _jax_stage1_step(monkeypatch, groups)
    assert set(got['metrics'][0]) == set(metrics) == {'Chamfer', 'Embed. Loss', 'Loss'}
    for name, value in metrics.items():
        np.testing.assert_allclose(got['metrics'][0][name], float(value), rtol=1e-4, err_msg=name)
    want_grads = _grads_by_name(grads)
    trained = {k: g for k, g in got['grads'].items() if not k.startswith('w_autoencoder.')}
    assert set(got['grads']) == set(trained)
    for name, g in trained.items():
        err = np.linalg.norm(g.numpy() - want_grads[name])
        assert err <= 1e-4 * np.linalg.norm(want_grads[name]) + 1e-7, name
    assert got['allreduce_bytes'] == 4 * sum(g.numel() for g in trained.values())
    for name, want in flax_to_state_dict({'batch_stats': new_stats}).items():
        np.testing.assert_allclose(got['state'][name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    start = spawned['cases'][('vqvae', groups)]['state']
    for name, want in flax_to_state_dict({'params': new_params}).items():
        after = got['state'][name].numpy()
        if name.startswith('w_autoencoder.'):
            assert torch.equal(got['state'][name], start[name]), name
            continue
        live = np.abs(want_grads[name]) > 1e-5
        np.testing.assert_allclose(after[live], want.numpy()[live], rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(after - want.numpy()).max() <= 2 * 0.004 + 1e-6, name


def test_stage1_two_rank_step_is_bit_equal_twice(spawned):
    """The same two-rank step from the same start, twice: the same bits on
    each rank."""
    for rank in spawned['steps'][('vqvae', 1)]:
        first, second = rank
        assert first['metrics'] == second['metrics']
        for name in first['state']:
            assert torch.equal(first['state'][name], second['state'][name]), name
        for name in first['grads']:
            assert torch.equal(first['grads'][name], second['grads'][name]), name


def _one_rank(case):
    return ranks.take_steps(case)


@pytest.fixture(scope='module')
def jax_stage2():
    """JAX's stage-2 step on a 2-device mesh (dropout 0, the posterior noise
    handed to it).  The W-nets hold no BatchNorm, so one step serves every G."""
    from pccf.dist import get_mesh
    from pccf.train import ModelEpoch, Trainer as JTrainer, get_learning_schema, get_w_autoencoder_loss as jloss
    from pccf.data.structures import WInputs as JWInputs, WTargets as JWTargets
    from tests.test_torch_port_wformer import fixed_gaussian_sample

    cfg, shell, v, ((w_q, logits), (w_e, one_hot, _)), eps = _stage2()
    loader = types.SimpleNamespace(batch_size=W_BATCH, n_batches=lambda inference=False: 2)
    jtrainer = JTrainer(ModelEpoch(shell, 'wae', variables=v), loader, jloss(cfg),
                        get_learning_schema(cfg.w_autoencoder), mesh=get_mesh(2))
    with pytest.MonkeyPatch.context() as mp:
        fixed_gaussian_sample(mp, [e.numpy() for e in eps])
        with japi.force_backend('jnp'):
            want = jtrainer.run_step(JWInputs(w_q, logits), JWTargets(w_e, one_hot, logits))
    return want, jax.device_get(jtrainer.state.params)


@pytest.mark.parametrize('groups', GROUPS)
def test_stage2_two_ranks_match_jax_mesh(spawned, jax_stage2, groups):
    """A W-autoencoder step (MSE + annealed KLD, ParamHistClipper, AdamW) on
    two gloo ranks against JAX's Trainer on a 2-device mesh: metrics and
    every parameter; the gradients (after the clipper, which read the
    averaged gradient) against the one-rank port's."""
    from tests.test_torch_port_stage2 import _zero_gradient

    got = _ranks_equal(spawned, ('wae', groups))
    want, params = jax_stage2
    assert set(got['metrics'][0]) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got['metrics'][0][name], value, rtol=1e-4, err_msg=name)
    for name, value in flax_to_state_dict({'params': params}).items():
        after = got['state'][name].numpy()
        if _zero_gradient(name):
            assert np.abs(after - value.numpy()).max() <= 2 * 0.0014, name
        else:
            assert _rel_l2(after, value.numpy()) <= 1e-4, name
    one = _one_rank(spawned['cases'][('wae', groups)])
    for name, g in one['grads'].items():
        if not _zero_gradient(name):
            assert _rel_l2(got['grads'][name].numpy(), g.numpy()) <= 1e-4, name


@pytest.mark.parametrize('groups', GROUPS)
def test_classifier_two_ranks_match_jax_mesh(spawned, monkeypatch, groups):
    """An SGD step of the classifier (dropout 0) on two gloo ranks against
    JAX's Trainer on a 2-device mesh: the metrics (the macro accuracy pooled
    over the global batch), every parameter and running statistic; the
    gradients against the one-rank port's."""
    from pccf.dist import get_mesh
    from pccf.train import Model, Trainer as JTrainer, get_classification_loss as jloss, get_learning_schema

    got = _ranks_equal(spawned, ('classifier', groups))
    cfg, cls, v, _, (cloud, labels) = _classifier()
    monkeypatch.setenv('PCCF_BN_GROUPS', str(groups))
    loader = types.SimpleNamespace(batch_size=CLS_BATCH, n_batches=lambda inference=False: 2)
    jtrainer = JTrainer(Model(cls, 'cls', variables=v), loader, jloss(), get_learning_schema(cfg.classifier),
                        mesh=get_mesh(2))
    with japi.force_backend('jnp'):
        want = jtrainer.run_step(JInputs(cloud=cloud), JTargets(ref_cloud=cloud, label=labels))
    assert set(got['metrics'][0]) == set(want) == {'CrossEntropy', 'Accuracy', 'Macro Accuracy'}
    for name, value in want.items():
        np.testing.assert_allclose(got['metrics'][0][name], value, rtol=1e-4, atol=1e-6, err_msg=name)
    state = jax.device_get(jtrainer.state)
    for name, value in flax_to_state_dict({'params': state.params, 'batch_stats': state.batch_stats}).items():
        assert _rel_l2(got['state'][name].numpy(), value.numpy()) <= 1e-4, name
    one = _one_rank(spawned['cases'][('classifier', groups)])
    for name, g in one['grads'].items():
        if name != ZERO_GRADIENT:
            assert _rel_l2(got['grads'][name].numpy(), g.numpy()) <= 1e-4, name


def test_classifier_with_dropout_two_ranks_equal_one(spawned):
    """Two SGD steps with the head's dropout at 0.5: each rank keeps its rows
    of the global batch's masks, so the two ranks take the one-rank steps."""
    got = _ranks_equal(spawned, ('dropout', 1))
    one = _one_rank(spawned['cases'][('dropout', 1)])
    for step, metrics in enumerate(one['metrics']):
        for name, value in metrics.items():
            np.testing.assert_allclose(got['metrics'][step][name], value, rtol=1e-4, atol=1e-6, err_msg=name)
    for name, value in one['state'].items():
        assert _rel_l2(got['state'][name].numpy(), value.numpy()) <= 1e-4, name


@pytest.mark.parametrize('name,groups', VAMP_CASES, ids=[f'{n}-{g}' for n, g in VAMP_CASES])
def test_vamp_prior_two_ranks_equal_one(spawned, name, groups):
    """A stage-2 step with the VampPrior's pseudo-inputs after each rank's
    rows: the BatchNorm statistics count them once (rank 0's), a dropout
    mask is the global rows' and the pseudo-inputs', so the two ranks take
    the one-rank step; the posterior noise is drawn by the trainers."""
    from tests.test_torch_port_stage2 import _zero_gradient

    def rounding(n):  # the convolutional W-encoder's first BatchNorm shift: the next Dense + BatchNorm takes it out
        return _zero_gradient(n) or n == 'wae.encoder.conv.0.bn.bias'

    got = _ranks_equal(spawned, (name, groups))
    one = _one_rank(spawned['cases'][(name, groups)])
    for step, metrics in enumerate(one['metrics']):
        for key, value in metrics.items():
            np.testing.assert_allclose(got['metrics'][step][key], value, rtol=1e-4, err_msg=(step, key))
    for key, g in one['grads'].items():
        if not rounding(key):
            assert _rel_l2(got['grads'][key].numpy(), g.numpy()) <= 1e-4, key
    for key, value in one['state'].items():
        if rounding(key):
            assert np.abs(got['state'][key].numpy() - value.numpy()).max() <= 2 * 0.0014, key
        else:
            assert _rel_l2(got['state'][key].numpy(), value.numpy()) <= 1e-4, key


def test_codebook_hook_installs_rank_zeros_rewrite(spawned):
    """Both ranks hold rank 0's rewrite (rank 1's own generator would draw
    otherwise), bit-equal to ``pccf/train/hooks.py``'s on the same usage,
    codebook and seed, at an epoch and at the final epoch."""
    from pccf.train.hooks import DiscreteSpaceOptimizer as JOptimizer

    codebook, one_hot = _codebook_case()
    c = CODEBOOK
    cfg = get_config_all([f'autoencoder.model.book_size={c["book"]}', f'autoencoder.model.w_dim={c["n_codes"] * 4}',
                          f'autoencoder.train.n_epochs={c["final"]}'])
    model = types.SimpleNamespace(params={'codebook': codebook}, epoch=1)
    diagnostic = types.SimpleNamespace(outputs_list=[types.SimpleNamespace(one_hot_idx=one_hot)])
    jopt = JOptimizer(diagnostic, types.SimpleNamespace(model=model), cfg)
    first = jopt._rewritten_codebook()
    model.params, model.epoch = {'codebook': first}, c['final']
    final = jopt._rewritten_codebook()
    for hook in spawned['hooks']:
        np.testing.assert_array_equal(hook['books'][0].numpy(), first)
        np.testing.assert_array_equal(hook['books'][1].numpy(), final)


def test_early_stopping_stops_every_rank_at_one_epoch(spawned):
    """A stage-1 ``fit`` with early stopping (patience 1) on two ranks: both
    ranks hold the same validation rows and weights and stop at the same
    epoch, before the last."""
    a, b = spawned['hooks']
    assert a['validation'] == b['validation'] and a['epoch'] == b['epoch'] < FIT_EPOCHS
    for name in a['state']:
        assert torch.equal(a['state'][name], b['state'][name]), name


def test_rank_zero_alone_writes_checkpoints(spawned):
    """The checkpoints of the two-rank ``fit`` (one after each epoch that
    early stopping let finish, and the last) are written by rank 0 alone."""
    assert not (spawned['dir'] / 'writes1.txt').exists()
    writes = [line.split() for line in (spawned['dir'] / 'writes0.txt').read_text().splitlines()]
    epoch = spawned['hooks'][0]['epoch']
    assert [(w[0], w[1]) for w in writes] == [('0', 'VQVAE')] * epoch
    assert [int(w[2]) for w in writes] == [*range(1, epoch), epoch]

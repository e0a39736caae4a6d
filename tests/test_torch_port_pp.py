"""Pipeline parallelism of pccf_torch (``pccf_torch/dist/pp.py``) against
JAX's ``tests/test_pp.py``, on the CPU.

One spawn of four gloo ranks (``tests/torch_dist_ranks.py``'s ``pp_cases``,
which imports no JAX) runs every case of ``tests/test_pp.py`` on the 1-D
grids of four and of two stages (``make_2d_grid(S, mp=S)``), the port's
transformer layers loaded from the same flax layers (d 16, 2 heads, FF 32,
batch 8 x 12 tokens, four layers) and run one at a time through
``torch.func.functional_call``: the pipeline against the sequential stack,
at 2, 4 and 8 microbatches, with the cross-attention memory as the side
input, with FF widths 32 and 16 zero-padded by ``stack_layer_params``, a
training gradient of every stage's layers, and the refusal of three layers
on four stages.  The reference is JAX's ``pipeline_apply`` on
``Mesh(jax.devices()[:S], ('pp',))`` of the conftest's virtual devices at
``tests/test_pp.py``'s tolerances (2e-5 / 1e-6, gradients 2e-4 / 1e-6),
held between each pipeline and the sequential stack of its own package, as
``tests/test_pp.py`` holds JAX's; the port's sequential stack is held to
JAX's at tests/test_torch_port_wformer.py's tolerance for the layers
(1e-4), and so the port's pipeline to JAX's.
The hop's two backward rules (the hop's cotangents summed over the stages,
the collection's passed as they are) are held by a pipeline of linear
layers whose every gradient, the replicated input's included, equals the
sequential stack's in the port.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pccf.dist.pp import pipeline_apply as jpipeline, shard_stacked_params as jshard, stack_layer_params as jstack
from pccf.nn.layers import TransformerDecoderLayer as JDec, TransformerEncoderLayer as JEnc, gelu_exact as jgelu
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.dist import launch
from pccf_torch.nn.layers import TransformerDecoderLayer, TransformerEncoderLayer, gelu_exact

from tests import torch_dist_ranks as ranks
from tests.test_pp import B, D, FF, HEADS, L, T

torch.set_num_threads(1)

RANKS = 4
VALUE = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)
WIDTHS = [32, 16, 32, 16]


def _mesh(pp):
    return Mesh(np.asarray(jax.devices()[:pp]).reshape(pp), ('pp',))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_params(flax_params):
    return [{k: v.clone() for k, v in flax_to_state_dict({'params': jax.tree.map(np.array, p)}).items()}
            for p in flax_params]


def _enc(seed, widths=None):
    x = _rand((B, T, D), seed)
    layers = [JEnc(D, HEADS, w, 0.0, jgelu) for w in (widths or [FF] * L)]
    params = [l.init(jax.random.key(i), jnp.asarray(x))['params'] for i, l in enumerate(layers)]
    return x, layers, params


class _Chain(torch.nn.Module):
    """A bias-free linear layer (the hop-rules case)."""

    def __init__(self) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(D, D))

    def forward(self, h):
        return torch.tanh(h @ self.weight.T)


def _chain_params():
    gen = torch.Generator().manual_seed(9)
    return [{'weight': torch.randn(D, D, generator=gen) / 4} for _ in range(L)]


CASES = ('sequential', 'microbatches', 'memory', 'padding', 'train', 'validates', 'hops')


def _payload():
    x0, _, p0 = _enc(0)
    x1, _, p1 = _enc(1)
    rng = np.random.default_rng(2)
    x2, mem = rng.standard_normal((B, T, D)).astype(np.float32), rng.standard_normal((B, T, D)).astype(np.float32)
    p2 = [JDec(D, HEADS, FF, 0.0, jgelu).init(jax.random.key(i), jnp.asarray(x2), jnp.asarray(mem))['params']
          for i in range(L)]
    x3 = np.random.default_rng(3).standard_normal((B, T, D)).astype(np.float32)
    p3 = [JEnc(D, HEADS, w, 0.0, jgelu).init(jax.random.key(i), jnp.asarray(x3))['params']
          for i, w in enumerate(WIDTHS)]
    x4, _, p4 = _enc(4)
    x6, _, p6 = _enc(6)
    enc, dec = TransformerEncoderLayer(D, HEADS, FF, gelu_exact), TransformerDecoderLayer(D, HEADS, FF, gelu_exact)
    t = torch.from_numpy
    return [dict(stages=4, layer=enc, params=_port_params(p0), x=t(x0), n_micro=[4]),
            dict(stages=2, layer=enc, params=_port_params(p1), x=t(x1), n_micro=[2, 4, 8]),
            dict(stages=4, layer=dec, params=_port_params(p2), x=t(x2), extra=t(mem), n_micro=[4]),
            dict(stages=2, layer=TransformerEncoderLayer(D, HEADS, max(WIDTHS), gelu_exact), params=_port_params(p3),
                 x=t(x3), n_micro=[4]),
            dict(stages=4, layer=enc, params=_port_params(p4), x=t(x4), n_micro=4, train=True,
                 target=t(_rand((B, T, D), 5))),
            dict(stages=4, layer=enc, params=_port_params(p6)[:3], x=t(x6), n_micro=[4]),
            dict(stages=4, layer=_Chain(), params=_chain_params(), x=t(_rand((B, T, D), 7)), n_micro=2, train=True,
                 target=t(_rand((B, T, D), 8)))]


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp('pp')
    torch.save(_payload(), out / 'pp.pt')
    launch(ranks.tp_ep_pp_cases, RANKS, 'gloo', None, None, str(out / 'pp.pt'), str(out))
    got = [torch.load(out / f'pp{r}.pt', weights_only=False) for r in range(RANKS)]
    return dict(zip(CASES, zip(*got)))


LAYERS = dict(rtol=1e-4, atol=1e-4)  # the port's layers against flax's (tests/test_torch_port_wformer.py)


def _sequential(layers, params, x, *extra):
    h = jnp.asarray(x)
    for layer, p in zip(layers, params):
        h = layer.apply({'params': p}, h, *extra)
    return np.asarray(h)


def _port_sequential(case, x=None, params=None):
    """The port's layers of a case one after another on the whole batch."""
    from torch.func import functional_call

    h = case['x'] if x is None else x
    for p in case['params'] if params is None else params:
        h = functional_call(case['layer'], p, (h, *([case['extra']] if 'extra' in case else [])))
    return h


def _check_outputs(results, name, want, stages):
    """Each stage's pipeline output against the port's sequential stack at
    test_pp.py's tolerance, that against JAX's sequential stack."""
    with torch.no_grad():
        mine = _port_sequential(_payload()[CASES.index(name)]).numpy()
    np.testing.assert_allclose(mine, want, **LAYERS)
    for r, res in enumerate(results):
        if r >= stages:
            assert res is None
            continue
        for out in res['out']:
            np.testing.assert_allclose(out.numpy(), mine, **VALUE)


def test_pipeline_matches_sequential(spawned):
    """Four stages, four microbatches, against the sequential stack and
    JAX's pipeline on four devices (``test_pipeline_matches_sequential``)."""
    x, layers, params = _enc(0)
    want = _sequential(layers, params, x)
    layer = layers[0]
    got = jpipeline(lambda p, h: layer.apply({'params': p}, h), jshard(jstack(params), _mesh(4)), jnp.asarray(x),
                    _mesh(4), n_micro=4)
    np.testing.assert_allclose(np.asarray(got), want, **VALUE)
    _check_outputs(spawned['sequential'], 'sequential', want, 4)


def test_pipeline_microbatch_counts(spawned):
    """Two stages at 2, 4 and 8 microbatches (``test_pipeline_microbatch_counts``)."""
    x, layers, params = _enc(1)
    _check_outputs(spawned['microbatches'], 'microbatches', _sequential(layers, params, x), 2)
    assert all(len(r['out']) == 3 for r in spawned['microbatches'][:2])


def test_pipeline_with_cross_attention_memory(spawned):
    """Decoder layers with each microbatch's rows of the memory
    (``test_pipeline_with_cross_attention_memory``)."""
    rng = np.random.default_rng(2)
    x, mem = rng.standard_normal((B, T, D)).astype(np.float32), rng.standard_normal((B, T, D)).astype(np.float32)
    layer = JDec(D, HEADS, FF, 0.0, jgelu)
    params = [layer.init(jax.random.key(i), jnp.asarray(x), jnp.asarray(mem))['params'] for i in range(L)]
    want = _sequential([layer] * L, params, x, jnp.asarray(mem))
    got = jpipeline(lambda p, h, m: layer.apply({'params': p}, h, m), jstack(params), jnp.asarray(x), _mesh(4),
                    n_micro=4, extra=jnp.asarray(mem))
    np.testing.assert_allclose(np.asarray(got), want, **VALUE)
    _check_outputs(spawned['memory'], 'memory', want, 4)


def test_pipeline_nonuniform_ff_padding(spawned):
    """FF widths 32, 16, 32, 16 zero-padded to 32 (``test_pipeline_nonuniform_ff_padding``),
    and ``stack_layer_params`` pads as JAX's does."""
    from pccf_torch.dist import stack_layer_params

    x = np.random.default_rng(3).standard_normal((B, T, D)).astype(np.float32)
    layers = [JEnc(D, HEADS, w, 0.0, jgelu) for w in WIDTHS]
    params = [l.init(jax.random.key(i), jnp.asarray(x))['params'] for i, l in enumerate(layers)]
    _check_outputs(spawned['padding'], 'padding', _sequential(layers, params, x), 2)
    got = stack_layer_params(_port_params(params))
    stacked = jax.device_get(jstack(params))
    for i in range(L):
        want = _port_params([jax.tree.map(lambda a, i=i: a[i], stacked)])[0]
        assert set(want) == set(got)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name][i].numpy(), value.numpy(), err_msg=name)


def test_pipeline_training_grads_match_sequential(spawned):
    """The loss and every stage's layer gradients against JAX's pipeline
    gradient on four devices (``test_pipeline_training_grads_match_sequential``);
    each stage holds the gradients of its own layers."""
    x, layers, params = _enc(4)
    target = jnp.asarray(_rand((B, T, D), 5))
    layer = layers[0]
    mesh = _mesh(4)

    def pp_loss(sp):
        out = jpipeline(lambda p, h: layer.apply({'params': p}, h), sp, jnp.asarray(x), mesh, n_micro=4)
        return jnp.mean((out - target) ** 2)

    v_pp, g_pp = jax.jit(jax.value_and_grad(pp_loss))(jshard(jstack(params), mesh))
    per_layer = [flax_to_state_dict({'params': jax.tree.map(lambda a, i=i: np.asarray(a)[i], g_pp)})
                 for i in range(L)]
    case = _payload()[CASES.index('train')]
    mine = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in case['params']]
    value = torch.mean((_port_sequential(case, params=mine) - case['target']) ** 2)
    value.backward()
    np.testing.assert_allclose(float(value), float(v_pp), rtol=1e-5)
    for k, (got, want) in enumerate(zip(mine, per_layer)):
        for name, v in got.items():  # the port's sequential gradients against JAX's pipeline's
            np.testing.assert_allclose(v.grad.numpy(), want[name].numpy(), **GRAD, err_msg=f'{k} {name}')
    for res in spawned['train']:
        np.testing.assert_allclose(res['value'], float(value), rtol=1e-5)
        assert res['count'] == L // 4
        for name, g in res['grads'].items():
            assert g.shape[0] == res['count']
            for k in range(res['count']):
                np.testing.assert_allclose(g[k].numpy(), mine[res['first'] + k][name].grad.numpy(), **GRAD,
                                           err_msg=name)


def test_pipeline_validates(spawned):
    """Three layers on four stages raise (``test_pipeline_validates``)."""
    for res in spawned['validates']:
        assert 'not divisible' in res['error']


def test_hop_and_collection_backward_rules(spawned):
    """A pipeline of four stages of one layer each, two microbatches: every
    stage's weight gradient and the replicated input's gradient equal the
    sequential stack's.  A hop whose backward did not sum the stages'
    cotangents would give the stages below the last no gradient; a
    collection whose backward summed would count the loss four times."""
    case = _payload()[-1]
    x = case['x'].clone().requires_grad_(True)
    weights = [p['weight'].clone().requires_grad_(True) for p in case['params']]
    h = x
    for w in weights:
        h = torch.tanh(h @ w.T)
    value = torch.mean((h - case['target']) ** 2)
    value.backward()
    for r, res in enumerate(spawned['hops']):
        assert res['first'] == r and res['count'] == 1
        np.testing.assert_allclose(res['value'], float(value), rtol=1e-6)
        np.testing.assert_allclose(res['grads']['weight'][0].numpy(), weights[r].grad.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res['dx'].numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-7)

"""Expert parallelism of pccf_torch (``shard_variables_ep`` in
``pccf_torch/dist/sharding.py``, the expert-parallel decode of
``pccf_torch/nn/decoders.py`` and the partial mode of the PCGen kernels'
plain version in ``pccf_torch/kernels/pcgen.py``) against JAX's
``tests/test_ep.py``, on the CPU.

One spawn of four gloo ranks (``tests/torch_dist_ranks.py``'s ``ep_cases``,
which imports no JAX) on the 1-D grid of four shards the decoder's eight
components two a rank and runs ``tests/test_ep.py``'s decoder (w_dim 32,
components (16, 8), 64 points): the eval forward (the module path: the
features gathered, the attention replicated, the mixtures summed) and the
gradient of the squared error, against JAX's replicated decoder and its
``shard_variables_ep`` on ``make_2d_mesh(8, mp=4)``, at ``tests/test_ep.py``'s
tolerances (values 1e-5 / 1e-6, gradients 1e-4 / 1e-6; each rank's expert
gradients are its components' slice of JAX's).  A decoder the fused gate
takes (w_dim 128, 256 points) decodes through the partial mode (the shares'
logits summed, each share mixed, the mixtures summed) against JAX's decoder.
In process: the partial mode's plain version, summed over the shares of
1, 2, 4 and 8 ranks, equals the unsharded plain mix, and its logits sum to
the unsharded logits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.dist.sharding import make_2d_mesh, shard_variables_ep as jshard
from pccf.kernels import api as japi
from pccf.nn.decoders import PCGenDecoder as JDecoder
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.dist import launch
from pccf_torch.kernels import ops, pcgen
from pccf_torch.nn.decoders import PCGenDecoder
from pccf_torch.nn.layers import relu

from tests import torch_dist_ranks as ranks
from tests.test_ep import G, N, _decoder_and_vars
from tests.test_torch_port_modules import randomize_stats

torch.set_num_threads(1)

RANKS = 4
VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
FUSED = dict(w_dim=128, conv_dims=(64, 32, 16), points=256)  # the fused gate's shapes: 128-multiple w_dim, 256 points


def _port(dec_cfg, v):
    dec = PCGenDecoder(w_dim=dec_cfg['w_dim'], sample_dim=4, n_components=G, map_dims=(8,),
                       conv_dims=dec_cfg['conv_dims'], tau=5.0, act=relu, filtering=False)
    dec.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, v)), strict=True)
    return dec


def _fused_case():
    dec = JDecoder(w_dim=FUSED['w_dim'], sample_dim=4, n_components=G, map_dims=(8,), conv_dims=FUSED['conv_dims'],
                   tau=5.0, act=jax.nn.relu, act_name='ReLU', filtering=False)
    w = jnp.asarray(np.random.default_rng(3).standard_normal((2, FUSED['w_dim'])).astype(np.float32))
    samp = jnp.asarray(np.random.default_rng(4).standard_normal((2, FUSED['points'], 4)).astype(np.float32))
    v = dec.init({'params': jax.random.key(5), 'sampling': jax.random.key(6)}, w, FUSED['points'], samp)
    return dec, randomize_stats(v, seed=7), w, samp


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp('ep')
    _, v, w, samp = _decoder_and_vars()
    target = np.random.default_rng(2).standard_normal((4, N, 3)).astype(np.float32)
    _, fv, fw, fsamp = _fused_case()
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 (a writable copy)
    cases = [dict(decoder=_port(dict(w_dim=32, conv_dims=(16, 8)), v), w=t(w), samp=t(samp), target=t(target),
                  grad=True),
             dict(decoder=_port(FUSED, fv), w=t(fw), samp=t(fsamp), target=None, grad=False)]
    torch.save(cases, out / 'ep.pt')
    launch(ranks.tp_ep_pp_cases, RANKS, 'gloo', None, str(out / 'ep.pt'), None, str(out))
    return [torch.load(out / f'ep{r}.pt', weights_only=False) for r in range(RANKS)]


def test_ep_forward_matches_replicated(spawned):
    """The eval forward with two of the eight components a rank against the
    replicated decoder and JAX's sharded one (``test_ep_forward_matches_replicated``);
    each rank holds its components' slice of every stack variable."""
    dec, variables, w, samp = _decoder_and_vars()
    ep_vars = jshard(variables, make_2d_mesh(8, mp=4), n_components=G)
    kern = ep_vars['params']['components']['conv_0']['dense']['kernel']
    assert kern.sharding.shard_shape(kern.shape)[0] == G // 4
    want = np.asarray(jax.jit(lambda v: dec.apply(v, w, N, samp, train=False))(ep_vars))
    np.testing.assert_allclose(want, np.asarray(dec.apply(variables, w, N, samp, train=False)), **VALUE)
    for r, res in enumerate(spawned):
        case = res[0]
        np.testing.assert_allclose(case['recon'].numpy(), want, **VALUE)
        assert (case['g0'], case['count']) == (r * G // RANKS, G // RANKS)
        assert case['shapes']['components.conv.0.dense.weight'][0] == G // RANKS
        assert case['shapes']['components.conv.0.bn.running_mean'][0] == G // RANKS
        assert case['shapes']['component_heads.dense.weight'][0] == G // RANKS
        assert case['shapes']['att.dense.weight'] == (G, G * 8)
        assert case['partial_calls'] == 0


def test_ep_grad_step_matches_replicated(spawned):
    """The value and every gradient of the squared error against JAX's on
    the sharded variables (``test_ep_grad_step_matches_replicated``): the
    replicated parameters' whole on every rank, the experts' this rank's
    slice, of the shard's shape."""
    dec, variables, w, samp = _decoder_and_vars()
    ep_vars = jshard(variables, make_2d_mesh(8, mp=4), n_components=G)
    target = jnp.asarray(np.random.default_rng(2).standard_normal((4, N, 3)).astype(np.float32))

    @jax.jit
    def loss_grad(params, stats):
        def loss(p):
            return jnp.mean((dec.apply({'params': p, 'batch_stats': stats}, w, N, samp, train=False) - target) ** 2)

        return jax.value_and_grad(loss)(params)

    value, grads = loss_grad(ep_vars['params'], ep_vars['batch_stats'])
    want = flax_to_state_dict({'params': jax.device_get(grads)})
    for res in spawned:
        case = res[0]
        np.testing.assert_allclose(case['value'], float(value), rtol=VALUE['rtol'])
        assert set(case['grads']) == set(want)
        for name, g in case['grads'].items():
            full = want[name].numpy()
            if name in case['sharded']:
                assert g.shape[0] == G // RANKS, name
                full = full[case['g0']:case['g0'] + case['count']]
            np.testing.assert_allclose(g.numpy(), full, **GRAD, err_msg=name)


def test_ep_fused_eval_goes_through_the_partial_mode(spawned):
    """A decoder the fused gate takes decodes through the partial mode, once
    a rank, and matches JAX's decoder."""
    dec, v, w, samp = _fused_case()
    with japi.force_backend('jnp'):
        want = np.asarray(dec.apply(v, w, FUSED['points'], samp, train=False))
    for res in spawned:
        case = res[1]
        assert case['partial_calls'] == 1
        np.testing.assert_allclose(case['recon'].numpy(), want, rtol=1e-4, atol=1e-5)


def _pack(g, dims, dm, seed):
    gen = torch.Generator().manual_seed(seed)

    def mk(*s, sc=1.0):
        return torch.randn(*s, generator=gen) * sc

    return pcgen.PCGenPack(mk(dims[0], dm, sc=dm ** -.5), mk(dims[0], sc=.1),
                           tuple(mk(g, dims[i + 1], dims[i], sc=dims[i] ** -.5) for i in range(len(dims) - 1)),
                           tuple(mk(g, dims[i + 1], sc=.1) for i in range(len(dims) - 1)),
                           mk(g, 3, dims[-1], sc=.25), mk(g, 3, sc=.1), mk(g, g * dims[-1], sc=.1), mk(g, sc=.1))


@pytest.mark.parametrize('mp', [1, 2, 4, 8])
def test_partial_plain_sums_to_the_unsharded_mix(mp):
    """The partial mode's plain version on each of ``mp`` shares: the shares'
    logits sum to the unsharded logits, and their mixtures, each with its
    slice of the softmax, to the unsharded plain mix (flagship-shaped
    layers at a small width and a general decoder of four layers)."""
    for dims, dm in (((128, 128, 64, 16), 16), ((96, 80, 48, 40, 24), 12)):
        pack = _pack(8, dims, dm, seed=len(dims))
        m = torch.relu(torch.randn(2, 64, dm, generator=torch.Generator().manual_seed(1)))
        w = torch.randn(2, dims[0], generator=torch.Generator().manual_seed(2))
        full = pcgen.plain(m, w, pack, tau=5.0, act_slope=0.2)
        feats = ops._pcgen_components(m, w, *pack.tensors()[:6], 0.2)[0]
        logits_full = torch.matmul(torch.cat(feats, dim=-1), pack.att_w.T) + pack.att_b
        count = 8 // mp
        shares = [pcgen.plain_partial(m, w, pack.share(r * count, count, r == 0), act_slope=0.2) for r in range(mp)]
        logits = sum(s[0] for s in shares)
        np.testing.assert_allclose(logits.numpy(), logits_full.numpy(), rtol=1e-5, atol=1e-5)
        assert all(s[1].shape == (2, 64, count, 3) for s in shares)
        mixed = sum(ops.pcgen_mix_share(logits, s[1], r * count, 5.0) for r, s in enumerate(shares))
        np.testing.assert_allclose(mixed.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)

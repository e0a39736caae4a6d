"""Tensor parallelism of pccf_torch (``pccf_torch/train/tp.py``,
``pccf_torch/dist/tp.py``, the rule of ``pccf_torch/dist/sharding.py``)
against JAX's ``pccf/train/tp.py`` and ``pccf/dist/sharding.py``, on the CPU.

One spawn of four gloo ranks (what each runs is
``tests/torch_dist_ranks.py``'s ``tp_cases``, which imports no JAX) lays
them out as ``make_2d_grid(4, mp=2)`` and mirrors every case of
``tests/test_tp.py``: the probe step ``tp_train_step``, ``TPTrainer`` over
three steps and an epoch, its checkpoint restored with its sharded layout
(and loaded on one device, and a one-device checkpoint loaded under TP),
the weights-only resumes of ``TPTrainer`` and of the ``tp_state`` probe,
and the eval forward.  The reference is JAX on ``make_2d_mesh(8, mp=2)`` of
the conftest's virtual devices at ``tests/test_tp.py``'s shapes (``TINY``,
batch 16) and tolerances (rtol 1e-4, atol 1e-5), from the same flax
weights, decoder sampling and Gumbel noise; JAX's trainer freezes the inner
CVAE as the port's does (``train_autoencoder.py:68``).  AdamW moves a
parameter by about ``lr · sign(g)`` on its first step, so the parameters
after it are held at the tolerances where the gradient is not near zero
(``|g| > 1e-5`` in the one-device port's step) and within ``2 lr``
everywhere, as tests/test_torch_port_train.py holds a stage-1 step, but for
the elements a max-pool near-tie moves (``NEAR_TIES``: two, of one tensor);
the probe's gradients are held to the one-device port step's.  In process:
the port's rule shards exactly the parameters whose flax leaves JAX's
``tp_spec`` shards, at ``TINY`` and at the flagship, and a one-rank grid
computes what one device does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs, Targets as JTargets
from pccf.dist.sharding import make_2d_mesh, tp_spec as jtp_spec
from pccf.kernels import api as japi
from pccf_torch import cli, convert
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.dist import launch, tp_layout
from pccf_torch.models import build_vqvae

from tests import torch_dist_ranks as ranks
from tests.test_tp import BATCH, TINY
from tests.test_torch_port_modules import load_port, randomize_stats
from tests.test_torch_port_train import _gumbel_patch

torch.set_num_threads(1)

RANKS = 4
TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.004
# the gradient operations whose first step reads the gradients' norms, means and deviations
GRAD_OPS = ('GradNormClipper', 'GradParamNormalizer', 'GradZScoreNormalizer')
# the elements of a parameter whose step may leave the tolerance: an EdgeConv
# max-pool winner at a near-tie takes another element when the sums run in
# another order (the one-device port and JAX part at 2 of the 8192 elements
# of encoder.edge_conv.1.weight at these clouds), and sends that element's
# gradient elsewhere; each such element stays within 2 lr.  Every element of
# every other parameter with a live gradient is held to TOL.
NEAR_TIES = {'encoder.edge_conv.1.weight': 2}


def _data():
    rng = np.random.default_rng(0)
    cloud = rng.standard_normal((BATCH, 128, 3)).astype(np.float32)
    sampling = rng.standard_normal((BATCH, 128, 4)).astype(np.float32)
    uniform = rng.uniform(1e-20, 1.0, (BATCH, 128, 2)).astype(np.float32)
    return cloud, sampling, uniform


@pytest.fixture(scope='module')
def flax_vars():
    from pccf.models import get_autoencoder

    cfg = get_config_all(TINY)
    module = get_autoencoder(cfg)
    cloud, _, _ = _data()
    init = jax.jit(lambda rngs, inputs, logits: module.init(rngs, inputs, logits, method='full_init'))
    v = init({'params': jax.random.key(0), 'sampling': jax.random.key(1)}, JInputs(cloud=jnp.asarray(cloud[:1])),
             jnp.zeros((1, 2)))
    return cfg, module, randomize_stats(v, seed=5)


@pytest.fixture(scope='module')
def spawned(tmp_path_factory, flax_vars):
    """One spawn of four gloo ranks; each rank's results."""
    out = tmp_path_factory.mktemp('tp')
    cfg = cli.get_config(TINY)[0]
    _, _, v = flax_vars
    cloud, sampling, uniform = _data()
    state = load_port(build_vqvae(cfg), v).state_dict()
    batch = (Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)),
             Targets(torch.from_numpy(cloud)), torch.from_numpy(uniform))
    torch.save(dict(config=cfg, state=state, batch=batch, steps_per_epoch=1, exp_dir=str(out / 'exp'),
                    grad_ops=GRAD_OPS), out / 'tp.pt')
    launch(ranks.tp_ep_pp_cases, RANKS, 'gloo', str(out / 'tp.pt'), None, None, str(out))
    return [torch.load(out / f'tp{r}.pt', weights_only=False) for r in range(RANKS)]


@pytest.fixture(scope='module')
def jax_step(flax_vars):
    """JAX's ``tp_train_step`` on ``make_2d_mesh(8, mp=2)`` (test_tp.py's
    probe), the sampling and the Gumbel noise handed to it."""
    from pccf.train import DataLoader, Model, Trainer, get_autoencoder_loss, get_learning_schema, tp_train_step

    cfg, module, v = flax_vars
    cloud, sampling, uniform = _data()

    class _DS:
        def __len__(self):
            return BATCH

        def __getitem__(self, i):
            return JInputs(cloud=cloud[i]), JTargets(ref_cloud=cloud[i], label=np.int64(0))

    model = Model(module, name='tp-port', variables=v)
    trainer = Trainer(model, DataLoader(_DS(), BATCH), get_autoencoder_loss(cfg),
                      get_learning_schema(cfg.autoencoder), frozen=('w_autoencoder',))
    with pytest.MonkeyPatch.context() as mp:
        _gumbel_patch(mp, uniform)
        inputs = JInputs(cloud=cloud, initial_sampling=sampling)
        targets = JTargets(ref_cloud=cloud, label=np.zeros(BATCH, np.int64))
        with japi.force_backend('jnp'):
            metrics, state = tp_train_step(trainer, make_2d_mesh(8, mp=2), inputs, targets, rng=jax.random.key(3),
                                           epoch=1.0, min_size=32, return_state=True)
    return metrics, jax.device_get(state.params), jax.device_get(state.batch_stats)


def _port_grads(flax_vars):
    """The one-device port step's gradients, which say where a gradient is near zero."""
    from pccf_torch.train import Trainer, get_autoencoder_loss

    cfg = cli.get_config(TINY)[0]
    cloud, sampling, uniform = _data()
    model = load_port(build_vqvae(cfg), flax_vars[2])
    Trainer(model, get_autoencoder_loss(cfg), cfg.autoencoder.train, 1).run_step(
        Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)), Targets(torch.from_numpy(cloud)),
        torch.from_numpy(uniform), epoch=1.0)
    return {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}


def test_tp_forward_matches_replicated(spawned, flax_vars):
    """The eval forward with column-sharded parameters, the batch over dp,
    against JAX's replicated forward (``test_tp_forward_matches_replicated``)."""
    _, module, v = flax_vars
    cloud, sampling, _ = _data()
    with japi.force_backend('jnp'):
        want = np.asarray(jax.jit(lambda v, inputs: module.apply(v, inputs, train=False,
                                                                 rngs={'sampling': jax.random.key(7)}).recon)(
            v, JInputs(cloud=cloud, initial_sampling=sampling)))
    for res in spawned:
        lo, rows = res['eval']['rows']
        np.testing.assert_allclose(res['eval']['recon'].numpy(), want[lo:lo + rows], **TOL)


def test_tp_train_step_matches_jax(spawned, jax_step, flax_vars):
    """``tp_train_step`` against JAX's (``test_tp_train_step_matches_dp``):
    metrics, parameters after AdamW and BatchNorm statistics; every rank
    gathers the same one-device state."""
    metrics, params, stats = jax_step
    grads = _port_grads(flax_vars)
    first = spawned[0]['probe']
    for res in spawned:
        got = res['probe']
        for name, value in metrics.items():
            assert got['metrics'][name] == pytest.approx(float(value), rel=TOL['rtol'], abs=TOL['atol']), name
        for name in got['state']:
            assert torch.equal(got['state'][name], first['state'][name]), name
    got = first['state']
    for name, want in flax_to_state_dict({'params': params}).items():
        after, want = got[name].numpy(), want.numpy()
        live = np.abs(grads[name]) > 1e-5 if name in grads else np.zeros(want.shape, bool)
        off = live & ~np.isclose(after, want, **TOL)
        assert off.sum() <= NEAR_TIES.get(name, 0), (name, int(off.sum()))
        assert np.abs(after - want).max() <= 2 * LR + 1e-6, name
    for name, want in flax_to_state_dict({'batch_stats': stats}).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), **TOL, err_msg=name)


def test_tp_probe_gradients_match_one_device_port(spawned, flax_vars):
    """The probe step's gradients, each slice gathered to the one-device
    layout, against the one-device port step's on the same batch and noise
    (rel L2 1e-4 a parameter, as tests/test_torch_port_dist.py holds a
    data-parallel step's): a sharded weight's gradient is the gather's
    backward, a replicated one's whole on every rank, none averaged over mp."""
    want = {k: torch.from_numpy(v) for k, v in _port_grads(flax_vars).items()}
    for res in spawned:
        got = res['probe']['grads']
        assert set(got) == set(want)
        for name, g in got.items():
            err = float(torch.linalg.norm(g - want[name]) / (torch.linalg.norm(want[name]) + 1e-30))
            assert err <= 1e-4 or float(torch.linalg.norm(want[name])) < 1e-6, (name, err)
    assert all(torch.equal(r['probe']['grads'][k], spawned[0]['probe']['grads'][k])
               for r in spawned[1:] for k in spawned[0]['probe']['grads'])


def test_tp_on_one_rank_is_one_device(flax_vars):
    """On a one-rank grid (no process group) every parameter the rule
    takes is sharded into one slice, the whole tensor: the eval forward is
    the unsharded model's bit for bit, and the one-device state round-trips
    through ``one_device_state`` / ``load_one_device_state``."""
    from pccf_torch.dist import make_2d_grid, shard_params_tp, tp

    cfg = cli.get_config(TINY)[0]
    cloud, sampling, _ = _data()
    inputs = Inputs(torch.from_numpy(cloud[:4]), initial_sampling=torch.from_numpy(sampling[:4]))
    plain = load_port(build_vqvae(cfg), flax_vars[2]).eval()
    sharded = load_port(build_vqvae(cfg), flax_vars[2]).eval()
    shards = shard_params_tp(sharded, make_2d_grid(1, mp=1), min_size=32)
    assert shards and set(shards) == set(tp.layouts(sharded)) == set(tp_layout(plain, 1, 32))
    with torch.no_grad():
        assert torch.equal(sharded(inputs).recon, plain(inputs).recon)
    state = tp.one_device_state(sharded)
    assert state.keys() == plain.state_dict().keys()
    assert all(torch.equal(v, plain.state_dict()[k]) for k, v in state.items())
    again = load_port(build_vqvae(cfg), flax_vars[2]).eval()
    shard_params_tp(again, make_2d_grid(1, mp=1), min_size=32)
    tp.load_one_device_state(again, state)
    assert all(torch.equal(v, state[k]) for k, v in tp.one_device_state(again).items())


def test_tp_actually_shards(spawned):
    """Some parameters are sharded, and each sharded parameter and its AdamW
    moments hold 1/mp of the one-device elements (``test_tp_actually_shards``)."""
    for res in spawned:
        layout = res['probe']['layout']
        assert layout
        for name, rec in layout.items():
            assert np.prod(rec['slice']) * 2 == np.prod(rec['full']), name
            assert rec['moments'] in ([], [rec['slice']] * 2), name


def test_tp_trainer_persists_state_across_steps(spawned):
    """Three ``TPTrainer`` steps advance the step and lower the loss, the
    parameters stay sharded, and an epoch over the grid runs
    (``test_tp_trainer_persists_state_across_steps``)."""
    for res in spawned:
        t = res['trainer']
        assert t['losses'][-1] < t['losses'][0], t['losses']
        assert t['step'] == 3 + 1  # three steps, then the epoch's one batch
        assert np.isfinite(t['epoch_loss'])
        # the frozen inner CVAE's slices have no moments
        assert t['layout'] and all(rec['moments'] in ([], [rec['slice']] * 2) for rec in t['layout'].values())
    assert all(r['trainer']['losses'] == spawned[0]['trainer']['losses'] for r in spawned)


def test_tp_checkpoint_restores_tp_layout(spawned):
    """A TP checkpoint restores the moments with their sharded layout, and
    training continues (``test_tp_checkpoint_restores_tp_layout``); the file
    holds the one-device layout: it loads on one device to equal weights and
    moments, and a one-device checkpoint loads under TP to its slices."""
    for res in spawned:
        ck = res['checkpoint']
        assert ck['same_moments'] and np.isfinite(ck['follow_loss']) and ck['step'] == 4
        assert ck['layout'] and all(rec['moments'] in ([], [rec['slice']] * 2) for rec in ck['layout'].values())
        assert any(rec['moments'] for rec in ck['layout'].values())
        for name, value in ck['weights'].items():
            assert torch.equal(ck['one_device'][name], value), name
        assert len(ck['one_device_moments']) == len(ck['tp_moments'])
        for a, b in zip(ck['one_device_moments'], ck['tp_moments']):
            assert torch.equal(a, b)
        fo = res['from_one_device']
        assert fo['step'] == fo['step_one'] == 1 and fo['sharded'] > 0
        assert all(fo['equal'].values()), [k for k, v in fo['equal'].items() if not v]


def test_tp_weights_only_resume_aligns_opt_counts(spawned):
    """A weights-only checkpoint at epoch 5 resumes ``TPTrainer`` at step
    ``5 · steps_per_epoch`` with every optimiser count there
    (``test_tp_weights_only_resume_aligns_opt_counts``)."""
    for res in spawned:
        assert res['resume']['step'] == 5
        assert res['resume']['counts'] and all(c == 5 for c in res['resume']['counts'])


def test_tp_state_probe_aligns_opt_counts(spawned):
    """``tp_state`` on a trainer resumed at epoch 4 from weights alone: the
    probe's step and every optimiser count at ``4 · steps_per_epoch``
    (``test_tp_state_probe_aligns_opt_counts``)."""
    for res in spawned:
        pr = res['probe_resume']
        assert pr['step'] == pr['expected'] == 4
        assert pr['counts'] and all(c == 4 for c in pr['counts'])


@pytest.mark.parametrize('op', GRAD_OPS)
def test_tp_grad_ops_see_the_one_device_gradient(spawned, flax_vars, op):
    """A gradient operation under TP reads the one-device gradient: the
    sharded slices' sums of squares (and sums) summed over ``mp``, a
    replicated gradient counted once.  Every gradient after the operation,
    gathered to the one-device layout, against the one-device port step's
    (rel L2 1e-4 a parameter, as tests/test_torch_port_dist.py holds a
    data-parallel step's)."""
    import dataclasses

    from pccf_torch.train import Trainer, get_autoencoder_loss

    cfg = cli.get_config(TINY)[0]
    cloud, sampling, uniform = _data()
    model = load_port(build_vqvae(cfg), flax_vars[2])
    Trainer(model, get_autoencoder_loss(cfg), dataclasses.replace(cfg.autoencoder.train, grad_op=op), 1).run_step(
        Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)), Targets(torch.from_numpy(cloud)),
        torch.from_numpy(uniform), epoch=1.0)
    want = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    for res in spawned:
        got = res['grad_ops'][op]
        assert set(got) == set(want)
        for name, g in got.items():
            err = float(torch.linalg.norm(g - want[name]) / (torch.linalg.norm(want[name]) + 1e-30))
            assert err <= 1e-4 or float(torch.linalg.norm(want[name])) < 1e-6, (name, err)


def _jax_sharded(cfg, min_size):
    """The port names of the flax leaves JAX's ``tp_spec`` shards over mp=2."""
    from pccf.models import get_autoencoder

    module = get_autoencoder(cfg)
    n = cfg.data.n_input_points
    shapes = jax.eval_shape(lambda: module.init({'params': jax.random.key(0), 'sampling': jax.random.key(1)},
                                                JInputs(cloud=jnp.zeros((1, n, 3))), jnp.zeros((1, 2)),
                                                method='full_init'))
    mesh = make_2d_mesh(2, mp=2)
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes['params'])[0]:
        keys = tuple(p.key for p in path)
        if jtp_spec(keys, leaf, mesh, 'mp', min_size) != jax.sharding.PartitionSpec():
            name, _ = convert._leaf(keys[:-1], keys[-1], np.zeros(leaf.shape, np.float32), 'params')
            names.add('.'.join([*(convert._rename(k) for k in keys[:-1]), name]))
    return names


@pytest.mark.parametrize('which', ['tiny', 'flagship'])
def test_rule_shards_the_leaves_jax_shards(which):
    """The port's rule (``tp_spec`` on each parameter's flax leaf) shards
    exactly the parameters whose flax leaves JAX's ``tp_spec`` shards, at
    ``TINY`` (min_size 32) and at the flagship (min_size 256)."""
    overrides, min_size = (TINY, 32) if which == 'tiny' else ([], 256)
    with torch.device('meta'):
        port = build_vqvae(cli.get_config(overrides)[0])
    got = set(tp_layout(port, 2, min_size))
    want = _jax_sharded(get_config_all(overrides), min_size)
    assert got == want
    assert any(n.startswith('decoder.components') for n in got)
    assert any('attn_0.query' in n for n in got) == (which == 'tiny')  # heads of 64 < 256 at the flagship

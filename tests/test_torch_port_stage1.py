"""The stage-1 entry point of pccf_torch against the JAX package, on the CPU.

The reconstruction objective under each ``recon_loss`` against
``pccf.train.losses.get_recon_loss``; one training step under the
Chamfer and the ChamferSinkhorn objectives against the JAX train step (the
ChamferEMD step is in tests/test_torch_port_train.py); the codebook hook's
rewrite against ``pccf/train/hooks.py``; the evaluation pass on stage-1
outputs; the eval forward, which decodes ``n_inference_output_points``; and
``train_autoencoder`` at a small width.  Inputs are made with numpy from a
seed.

Tolerances: Chamfer and Sinkhorn values 1e-5 relative (the same float32
algorithm; the sums add in other orders and the golden expands the squared
distances where the port takes differences); ApproxMatch EMD 5e-4, the
tolerance of tests/test_kernels_interpret.py (exp of -4^7 · d² amplifies the
rounding of d²); the training step as tests/test_torch_port_train.py holds
it; the codebook rewrite exact (the same draws from the same generator, in
the same order); the eval forward at 1e-4 on the samples whose codes all
agree, as tests/test_torch_port_slice.py holds the decode.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.data.structures import Inputs, Outputs, Targets
from pccf_torch.kernels import api

from tests.test_torch_port_modules import load_port, randomize_stats
from tests.test_torch_port_train import JAX_OBJECTIVES, TRAIN_OVERRIDES, _port_train_config, check_train_step

torch.set_num_threads(1)


def _clouds(n, m, seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)) * 0.5).astype(np.float32), (rng.standard_normal((b, m, 3)) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize('recon_loss', ['ChamferEMD', 'Chamfer', 'ChamferSinkhorn'])
def test_recon_loss_matches_jax(monkeypatch, recon_loss):
    """The calculations each objective holds, their values on the same
    clouds, and one kernel call for each pair (JAX with ``user.cpu`` false,
    its default and the only setting the port has)."""
    from pccf.data.structures import Outputs as JOutputs, Targets as JTargets
    from pccf.train.losses import get_recon_loss as jget
    from pccf_torch.train import get_recon_loss

    cfg = get_config_all([f'autoencoder/objective={JAX_OBJECTIVES[recon_loss]}'])
    assert cfg.user.cpu is False
    pcfg = tc.SliceConfig(autoencoder=tc.AutoEncoderConfig(train=tc.AutoEncoderTrainConfig(recon_loss=recon_loss)))
    x, y = _clouds(128, 96, 1)
    with japi.force_backend('jnp'):
        want_loss, want = jget(cfg).loss_and_metrics(JOutputs(recon=jnp.asarray(x)), JTargets(ref_cloud=jnp.asarray(y)))
    calls = []
    for name in ('chamfer', 'chamfer_match_cost', 'chamfer_sinkhorn_cost'):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    got_loss, got = get_recon_loss(pcfg).loss_and_metrics(Outputs(recon=torch.from_numpy(x)),
                                                          Targets(ref_cloud=torch.from_numpy(y)))
    assert set(got) == set(want)
    expect = {'ChamferEMD': 'chamfer_match_cost', 'Chamfer': 'chamfer',
              'ChamferSinkhorn': 'chamfer_sinkhorn_cost'}[recon_loss]
    assert calls == [expect]
    for name, value in want.items():
        rtol = 5e-4 if recon_loss == 'ChamferEMD' and name in ('EMD', 'Loss') else 1e-5
        np.testing.assert_allclose(float(got[name]), float(value), rtol=rtol, err_msg=name)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=5e-4)


def test_recon_loss_refuses_unknown_names():
    from pccf_torch.train import get_recon_loss

    with pytest.raises(ValueError, match='recon_loss'):
        get_recon_loss(tc.SliceConfig(autoencoder=tc.AutoEncoderConfig(
            train=tc.AutoEncoderTrainConfig(recon_loss='EMD'))))


@pytest.mark.parametrize('recon_loss', ['Chamfer', 'ChamferSinkhorn'])
def test_train_step_matches_jax(monkeypatch, recon_loss):
    """One step under the objective (8 · embedding loss added), from the same
    flax weights, batch and noise: losses, every gradient, the BatchNorm
    statistics and the parameters after AdamW."""
    names = {'Chamfer', 'Embed. Loss', 'Loss'} | ({'EMD'} if recon_loss == 'ChamferSinkhorn' else set())
    check_train_step(monkeypatch, recon_loss, names)


# ------------------------------------------------------------- codebook hook


def test_codebook_rewrite_matches_jax():
    """Two firings of the hook on the same usage counts, codebook and seed:
    unused entries become noisy copies of used entries of their slot, drawn
    in JAX's order, then 1000 at the final epoch."""
    from pccf.train.hooks import DiscreteSpaceOptimizer as JOptimizer
    from pccf_torch.train.hooks import DEAD_ENTRY, rewritten_codebook

    n_codes, book, dim, final = 6, 8, 4, 5
    rng = np.random.default_rng(7)
    codebook = rng.standard_normal((n_codes, book, dim)).astype(np.float32)
    idx = rng.integers(0, 5, (10, n_codes))  # entries 5-7 are never chosen
    idx[:, 2] = 3  # one slot with a single used entry
    one_hot = np.eye(book, dtype=np.float32)[idx]
    usage = one_hot.sum(axis=0).astype(np.int64)
    cfg = get_config_all(['autoencoder.model.book_size=8', 'autoencoder.model.w_dim=24',
                          f'autoencoder.train.n_epochs={final}'])
    model = types.SimpleNamespace(params={'codebook': codebook}, epoch=1)
    diagnostic = types.SimpleNamespace(outputs_list=[types.SimpleNamespace(one_hot_idx=one_hot[:6]),
                                                     types.SimpleNamespace(one_hot_idx=one_hot[6:])])
    jopt = JOptimizer(diagnostic, types.SimpleNamespace(model=model), cfg)
    assert (jopt.n_codes, jopt.book_size, jopt.final_epoch, jopt.vq_noise) == (n_codes, book, final, 2)
    port_rng = np.random.default_rng(0)  # JAX seeds with cfg.user.seed or 0
    want = jopt._rewritten_codebook()
    got = rewritten_codebook(codebook, usage, port_rng, 2.0, at_final=False)
    np.testing.assert_array_equal(got, want)
    used = usage > 0
    assert (got[used] == codebook[used]).all() and not (got[~used] == codebook[~used]).any()
    assert np.abs(got[2, ~used[2]] - codebook[2, 3]).max() < 6 * 2.0  # copies of the one used entry, noise 2
    model.params, model.epoch = {'codebook': want}, final
    want = jopt._rewritten_codebook()
    got = rewritten_codebook(got, usage, port_rng, 2.0, at_final=True)
    np.testing.assert_array_equal(got, want)
    assert (got[~used] == DEAD_ENTRY).all() and (got[used] == codebook[used]).all()
    assert rewritten_codebook(codebook, np.ones_like(usage), port_rng, 2.0, at_final=False) is None


def test_call_every_fires_on_multiples():
    from pccf_torch.train.hooks import call_every

    fired = []
    hook = call_every(3)(lambda trainer: fired.append(trainer.epoch))
    for epoch in range(1, 10):
        hook(types.SimpleNamespace(epoch=epoch))
    assert fired == [3, 6, 9]


# ------------------------------------------------------ the two repairs


def test_test_pass_counts_stage1_batches_from_their_inputs():
    """A stage-1 Test over 5 clouds in batches of 2, 2 and 1: each metric is
    the mean over the samples (each batch weighted by its clouds), with the
    eval sampling drawn from the pass's generator."""
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.train import Test, get_autoencoder_loss
    from pccf_torch.train.autoencoder import CloudLoader

    pcfg = _port_train_config()
    vq = build_vqvae(pcfg)
    init_from_seed(vq, 3)
    clouds = torch.from_numpy(_clouds(256, 256, 4, b=5)[0])
    loss = get_autoencoder_loss(pcfg)
    loader = CloudLoader(clouds, 2)
    got = Test(vq, loader, loss, seed=5)()
    per_sample: dict[str, list] = {}
    generator = torch.Generator().manual_seed(5 + 17)
    with torch.no_grad():
        for inputs, targets in loader.batches():
            values = loss.compute_all(vq(inputs, None, generator), targets)
            values['Loss'] = loss.loss_expr(values)
            for name, v in values.items():
                per_sample.setdefault(name, []).append(v)
    assert [len(b[0].cloud) for b in loader.batches()] == [2, 2, 1]
    assert set(got) == set(per_sample) == {'Chamfer', 'EMD', 'Embed. Loss', 'Loss'}
    for name, values in per_sample.items():
        assert got[name] == pytest.approx(float(torch.cat(values).mean()), rel=1e-5), name


def test_eval_forward_decodes_the_inference_points():
    """512 input points and 256 target points: in eval the port draws the
    decoder's sampling for 256 points, as JAX's ``__call__(train=False)``
    decodes ``n_inference_output_points``; the reconstruction from that
    sampling matches JAX's."""
    from pccf.data.structures import Inputs as JInputs
    from pccf.models import get_autoencoder
    from pccf_torch.models import build_vqvae

    overrides = [o for o in TRAIN_OVERRIDES if not o.startswith(('data.n_input_points', 'data.n_target_points'))]
    cfg = get_config_all(overrides + ['data.n_input_points=512', 'data.n_target_points=256'])
    cloud = _clouds(512, 8, 6)[0]
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    v = randomize_stats(init({'params': jax.random.key(2), 'sampling': jax.random.key(3)},
                             JInputs(cloud=jnp.asarray(cloud)), jnp.zeros((2, 2))), seed=6)
    pcfg = _port_train_config()
    pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, n_input_points=512, n_target_points=256))
    port = load_port(build_vqvae(pcfg), v)
    with torch.no_grad():
        got = port(Inputs(torch.from_numpy(cloud)), None, torch.Generator().manual_seed(8))
    sampling = torch.randn((2, 256, 4), generator=torch.Generator().manual_seed(8))
    with japi.force_backend('jnp'):
        own = jvq.apply(v, JInputs(cloud=jnp.asarray(cloud)), train=False, rngs={'sampling': jax.random.key(4)})
        want = jvq.apply(v, JInputs(cloud=jnp.asarray(cloud), initial_sampling=jnp.asarray(sampling.numpy())),
                         train=False)
    assert got.recon.shape == own.recon.shape == want.recon.shape == (2, 256, 3)
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= 0.99
    same = (idx == jidx).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(got.recon.numpy()[same], np.asarray(want.recon)[same], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ entry point


@pytest.mark.parametrize('recon_loss', ['ChamferEMD', 'Chamfer', 'ChamferSinkhorn'])
def test_train_autoencoder_runs_on_the_cpu(monkeypatch, recon_loss):
    """Two epochs of 5 clouds at batch 2 (two steps an epoch, the trailing
    cloud dropped), a validation pass after each, the codebook hook every
    second epoch (so at the final one only: dead entries go to 1000), the
    final test with ApproxMatch EMD attached when the objective lacks it."""
    from pccf_torch.data import synthetic
    from pccf_torch.models import build_vqvae
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.train import Diagnostic
    from pccf_torch.train.autoencoder import train_autoencoder
    from pccf_torch.train.hooks import DEAD_ENTRY

    pcfg = _port_train_config(recon_loss)
    pcfg = dataclasses.replace(pcfg, autoencoder=dataclasses.replace(pcfg.autoencoder, diagnose_every=2))
    vq = build_vqvae(pcfg)
    init_from_seed(vq, 9)
    passes = []
    real = Diagnostic.__call__
    monkeypatch.setattr(Diagnostic, '__call__', lambda self, epoch=0: passes.append(epoch) or real(self, epoch))
    train, test = (torch.from_numpy(synthetic.batch(seed, n, 256)) for seed, n in ((10, 5), (11, 3)))
    out = train_autoencoder(pcfg, vq, train, test, n_epochs=2, device='cpu')
    trainer, hook = out['trainer'], out['codebook_hook']
    assert trainer.epoch == 2 and trainer.step == 4 and len(trainer.validation_log) == 2
    assert passes == [2]
    assert (hook.last_usage.sum(axis=1) == 5).all()  # one code per slot per training cloud
    unused = hook.last_usage == 0
    assert unused.any() and bool((vq.codebook[torch.from_numpy(unused)] == DEAD_ENTRY).all())
    assert 'EMD' in out['test'] and np.isfinite(list(out['test'].values())).all()
    assert out['loss'] == out['test']['Chamfer']
    assert all(not p.requires_grad for p in vq.w_autoencoder.parameters())
    assert set(api.launch_counts().values()) == {0}

"""The port's training harness against the JAX package's, on the CPU: the
six gradient operations against their optax transforms (5 steps of the same
gradients, the running statistics included, rtol 1e-5); early stopping
against ``pccf.train.hooks.EarlyStoppingCallback`` on hypothesis-drawn
histories, in both directions and on the composite ``'Loss'`` of ChamferEMD
(the same stop, exactly); a stage-1 run of 2 epochs against 1 epoch, a
checkpoint, ``user.load_checkpoint=-1`` and 1 more (bit-equal, the
``HistClipper`` state included); the CSV and SQLite trackers against JAX's
on one metric stream (byte-equal files, equal rows); the synthetic dataset's
train and test batches of epochs 1-2 against JAX's ``DataLoader`` (exact),
the batch assembler's numpy version against ``pccf.native`` (bit-equal)
with every augmentation on and off; and the widened kernels' plain versions
against JAX: attention at heads of 256 and 512 (the W-encoder stack at
d = 512 against the XLA layers, 1e-4) and PCGen at 5 and 6 component layers
(against the jnp decoder, 1e-4).
"""

import itertools
import sqlite3
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pccf.kernels import api as japi
from pccf.train import grad_ops as jax_grad_ops
from pccf_torch.data.protocols import Singleton
from pccf_torch.train import grad_ops
from test_pipeline import TINY

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-4)  # the plain versions against JAX's XLA layers, as the module tests hold them

SHAPES = {'a': (4, 3), 'b': (5,), 'c': (2, 2, 2)}
OPS = [('GradParamNormalizer', 'ZStat'), ('GradZScoreNormalizer', 'ZStat'), ('GradValueClipper', 'ZStat'),
       ('GradNormClipper', 'ZStat'), ('HistClipper', 'ZStat'), ('HistClipper', 'EMA'),
       ('ParamHistClipper', 'ZStat'), ('ParamHistClipper', 'EMA')]


def _grads(step: int) -> dict[str, np.ndarray]:
    """Gradients whose global norm crosses 1 and, at step 3, an outlier."""
    rng = np.random.default_rng(100 + step)
    scale = (0.05, 0.6, 1.0, 8.0, 0.3)[step]
    g = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    if step == 3:
        g['b'] *= 40.0
    return g


def _params():
    return {k: torch.nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()}


def _apply(op, params, grads):
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    op()
    return {k: p.grad.numpy().copy() for k, p in params.items()}


@pytest.mark.parametrize('name,criterion', OPS)
def test_grad_op_matches_optax(name, criterion):
    params = _params()
    op = grad_ops.get_grad_op(name, params.items(), criterion)
    tx = jax_grad_ops.get_grad_op(name, criterion)
    state = tx.init({k: jnp.zeros(s) for k, s in SHAPES.items()})
    for step in range(5):
        grads = _grads(step)
        want, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state)
        got = _apply(op, params, grads)
        for k in SHAPES:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-7, err_msg=(name, step, k))
        if name == 'HistClipper':
            np.testing.assert_allclose(op.mean.numpy(), [float(state.mean)], rtol=1e-5)
            np.testing.assert_allclose(op.var.numpy(), [float(state.var)], rtol=1e-5, atol=1e-9)
            assert op.seen == int(state.seen)
        elif name == 'ParamHistClipper':
            for k, (mean, var) in op.state().items():
                np.testing.assert_allclose((mean, var), (float(state.mean[k]), float(state.var[k])), rtol=1e-5,
                                           atol=1e-9)
            assert op.seen == int(state.seen)


def test_hist_clipper_recovers_from_a_zero_first_norm():
    """``test_harness_units.py``'s case: a first step of zero gradients does
    not pin the history at 0."""
    params = _params()
    op = grad_ops.get_grad_op('HistClipper', params.items(), 'ZStat')
    _apply(op, params, {k: np.zeros(s, np.float32) for k, s in SHAPES.items()})
    grads = _grads(2)
    got = _apply(op, params, grads)
    for k in SHAPES:
        np.testing.assert_array_equal(got[k], grads[k])
    assert float(op.mean[0]) > 0


@pytest.mark.parametrize('name', ['HistClipper', 'ParamHistClipper'])
def test_history_survives_a_checkpoint_and_restarts_without_one(name):
    """The state a sidecar keeps continues the history exactly; a fresh op
    (a weights-only resume) clips nothing at its first step, as
    ``test_hist_clipper_survives_weights_only_resume`` asks of JAX's."""
    params = _params()
    whole = grad_ops.get_grad_op(name, params.items(), 'ZStat')
    outs = [_apply(whole, params, _grads(s)) for s in range(5)]
    first = grad_ops.get_grad_op(name, params.items(), 'ZStat')
    for s in range(3):
        _apply(first, params, _grads(s))
    resumed = grad_ops.get_grad_op(name, params.items(), 'ZStat')
    resumed.load_state_dict(first.state_dict())
    for s in (3, 4):
        got = _apply(resumed, params, _grads(s))
        assert all(np.array_equal(got[k], outs[s][k]) for k in SHAPES)
    fresh = grad_ops.get_grad_op(name, params.items(), 'ZStat')
    got = _apply(fresh, params, _grads(3))
    assert all(np.array_equal(got[k], _grads(3)[k]) for k in SHAPES)


# --------------------------------------------------------- early stopping


def _stop_epoch(callback, rows, stop_exc):
    trainer = types.SimpleNamespace(validation_log=[], metrics_log=[])
    trace = []
    for i, row in enumerate(rows):
        trainer.validation_log.append(row)
        try:
            callback(trainer)
        except stop_exc:
            return i + 1, trace
        trace.append((callback.best, callback.stale, list(callback.history)))
    return None, trace


def _pair(kind: str):
    """JAX's and the port's monitored objective of one kind."""
    from pccf.config import get_config_all
    from pccf.train import losses as jl
    from pccf.train.objectives import Metric as JMetric
    from pccf_torch.config import SliceConfig
    from pccf_torch.train import losses as pl
    from pccf_torch.train.objectives import Metric as PMetric

    if kind == 'loss':
        return jl.get_classification_loss(), pl.get_classification_loss()
    if kind == 'higher':
        return (JMetric(lambda o, t: o, 'Accuracy', higher_is_better=True),
                PMetric(lambda o, t: o, 'Accuracy', higher_is_better=True))
    return jl.get_recon_loss(get_config_all([])), pl.get_recon_loss(SliceConfig())


@settings(max_examples=60, deadline=None)
@given(values=st.lists(st.floats(0.0, 5.0, allow_nan=False), min_size=1, max_size=25),
       extra=st.lists(st.floats(0.0, 5.0, allow_nan=False), min_size=25, max_size=25),
       window=st.integers(1, 5), patience=st.integers(1, 4), kind=st.sampled_from(['loss', 'higher', 'composite']),
       filt=st.sampled_from(['trailing', 'moving']))
def test_early_stopping_stops_where_jax_does(values, extra, window, patience, kind, filt):
    from pccf.train import hooks as jh
    from pccf.train.runners import StopTraining as JStop
    from pccf_torch.train import hooks as ph
    from pccf_torch.train.runners import StopTraining as PStop

    jmetric, pmetric = _pair(kind)
    rows = []
    for v, e in zip(values, extra):
        if kind == 'composite':  # 'Loss' in the row is the training loss, not the criterion
            rows.append({'Chamfer': v, 'EMD': e, 'Embedding Loss': 1.0, 'Loss': 100.0 + v})
        else:
            rows.append({jmetric.name: v, 'Other': e})
    jf = jh.get_trailing_mean(window) if filt == 'trailing' else jh.get_moving_average()
    pf = ph.get_trailing_mean(window) if filt == 'trailing' else ph.get_moving_average()
    want = _stop_epoch(jh.EarlyStoppingCallback(jmetric, filter_fn=jf, patience=patience), rows, JStop)
    got = _stop_epoch(ph.EarlyStoppingCallback(pmetric, filter_fn=pf, patience=patience), rows, PStop)
    assert got == want


def test_composite_criterion_reads_its_leaves():
    from pccf.config import get_config_all
    from pccf.train.hooks import resolve_monitored_value as jresolve
    from pccf.train.losses import get_recon_loss as jrecon
    from pccf_torch.config import SliceConfig
    from pccf_torch.train.hooks import resolve_monitored_value
    from pccf_torch.train.losses import get_recon_loss

    row = {'Chamfer': 0.25, 'EMD': 0.5, 'Loss': 9.0}
    assert resolve_monitored_value(get_recon_loss(SliceConfig()), row) == jresolve(jrecon(get_config_all([])), row)
    assert resolve_monitored_value(get_recon_loss(SliceConfig()), row) == ('Chamfer+EMD', 0.75)


# ------------------------------------------------------------ checkpoints


@pytest.fixture()
def exp_root(tmp_path, monkeypatch):
    """A fresh experiment root and dataset registry for each run of the entry points."""
    Singleton.reset_all()

    def root(name: str):
        monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / name))
        monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
        return tmp_path / name

    yield root
    Singleton.reset_all()


def test_stage1_resume_is_bit_equal(exp_root):
    """Two epochs in one run equal one epoch, the final checkpoint, and a run
    resumed from it for the second: the weights, the optimiser, the
    history clipper, the step, the generator and the epoch's metrics."""
    from pccf_torch.train import autoencoder

    args = [*TINY, 'user.cpu=true', 'autoencoder.train.learn.grad_op=HistClipper']
    exp_root('whole')
    whole = autoencoder.main(args)
    exp_root('resumed')
    autoencoder.main([*args, 'autoencoder.train.n_epochs=1'])
    resumed = autoencoder.main([*args, 'user.load_checkpoint=-1'])
    a, b = whole['trainer'], resumed['trainer']
    assert (a.epoch, a.step) == (b.epoch, b.step) == (2, 3 * 2)
    assert a.metrics_log[-1] == b.metrics_log[-1] and len(b.metrics_log) == 1
    assert a.validation_log[-1] == b.validation_log[-1] and whole['test'] == resumed['test']
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    sa, sb = a.grad_op.state_dict(), b.grad_op.state_dict()
    assert sa['seen'] == sb['seen'] == 6 and torch.equal(sa['mean'], sb['mean']) and torch.equal(sa['var'], sb['var'])
    for x, y in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert all(torch.equal(x[n], y[n]) for n in x)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_errors_as_jax(exp_root, tmp_path):
    from pccf_torch.config import SliceConfig
    from pccf_torch.experiment import Experiment
    from pccf_torch.train.checkpoint import Checkpoint

    model = torch.nn.Linear(2, 2)
    with Experiment(SliceConfig(), name='e', par_dir=tmp_path).create_run():
        ck = Checkpoint('m')
        with pytest.raises(FileNotFoundError, match='No checkpoints'):
            ck.load(model)
        ck.save(model, 3)
        ck.save(model, 7)
        assert ck.epochs() == [3, 7] and ck.resolve(-1) == 7 and ck.resolve(-2) == 3
        with pytest.raises(FileNotFoundError, match=r'Checkpoint epoch 5 not in \[3, 7\]'):
            ck.load(model, 5)
        assert (tmp_path / 'e' / 'models' / 'm' / 'checkpoints' / 'epoch_7').is_file()


# --------------------------------------------------------------- trackers


def _stream():
    yield 'VQVAE', 'Train', 1, {'Loss': 1.5, 'lr': 0.004}
    yield 'VQVAE', 'Validation', 1, {'Loss': 1.75}
    yield 'VQVAE', 'Train', 2, {'Loss': 1.25, 'lr': 0.0039, 'epoch_time_s': 0.5}  # a metric appears mid-run
    yield 'DGCNN', 'FinalTest', 2, {'CrossEntropy': 0.625, 'Accuracy': 1.0}


def test_csv_and_sqlite_trackers_equal_jax(tmp_path):
    from pccf.train import trackers as jt
    from pccf_torch.train import trackers as pt

    dirs = {}
    for side, mod in (('jax', jt), ('port', pt)):
        exp = types.SimpleNamespace(exp_dir=tmp_path / side)
        exp.exp_dir.mkdir()
        for run in range(2):  # a resumed run appends under the file's header
            trackers = [mod.CSVDumper(), mod.SQLiteTracker()]
            for tracker in trackers:
                tracker.start(exp)
            for model, source, epoch, metrics in _stream():
                for tracker in trackers:
                    tracker.log_metrics(model=model, source=source, epoch=epoch + 10 * run, metrics=metrics)
            for tracker in trackers:
                tracker.stop()
        dirs[side] = exp.exp_dir
    files = sorted(p.name for p in (dirs['jax'] / 'metrics').iterdir())
    assert files == sorted(p.name for p in (dirs['port'] / 'metrics').iterdir()) and len(files) == 3
    for name in files:
        assert (dirs['port'] / 'metrics' / name).read_bytes() == (dirs['jax'] / 'metrics' / name).read_bytes()
    rows = [sqlite3.connect(d / 'metrics.db').execute('SELECT * FROM metrics').fetchall() for d in dirs.values()]
    assert rows[0] == rows[1] and len(rows[0]) == 16


# ------------------------------------------------------------------- data


def _jax_batches(overrides):
    from pccf.config import get_config_all
    from pccf.data import get_datasets
    from pccf.data.protocols import Singleton as JSingleton
    from pccf.train.loader import DataLoader

    JSingleton.reset_all()
    cfg = get_config_all(overrides)
    train, test = get_datasets(cfg)
    batch = cfg.classifier.train.batch_size
    out = [list(DataLoader(train, batch).epoch_iterator(e, prefetch=0)) for e in (1, 2)]
    return out, list(DataLoader(test, batch).get_loader(inference=True))


@pytest.mark.parametrize('augment', [[], ['data.rotate=true', 'data.translate=true', 'data.resample=true']])
def test_synthetic_batches_equal_jax(exp_root, augment):
    from pccf_torch import cli
    from pccf_torch.data.dataset import get_datasets
    from pccf_torch.train.runners import Loader

    overrides = [*TINY, 'user.seed=5', *augment]
    want_train, want_test = _jax_batches(overrides)
    cfg, _ = cli.get_config(overrides)
    train, test = get_datasets(cfg, 'cpu')
    batch = cfg.classifier.train.batch_size
    for epoch, want in zip((1, 2), want_train):
        got = list(Loader(train, batch, train.seed).epoch_iterator(epoch))
        assert len(got) == len(want)
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi.cloud.numpy(), wi.cloud)
            np.testing.assert_array_equal(gt.ref_cloud.numpy(), wt.ref_cloud)
            np.testing.assert_array_equal(gt.label.numpy(), wt.label)
    got = list(Loader(test, batch, test.seed).batches())
    assert len(got) == len(want_test)
    for (gi, gt), (wi, wt) in zip(got, want_test):
        np.testing.assert_array_equal(gi.cloud.numpy(), wi.cloud)
        np.testing.assert_array_equal(gi.indices.numpy(), wi.indices)
        np.testing.assert_array_equal(gt.label.numpy(), wt.label)


@pytest.mark.parametrize('jitter,resample,rotate,translate', list(itertools.product([False, True], repeat=4)))
def test_assembler_plain_equals_native(jitter, resample, rotate, translate):
    from pccf import native
    from pccf_torch.data import sampler

    rng = np.random.default_rng(7)
    clouds = (rng.standard_normal((5, 301, 3)) * [1.0, 2.0, 0.5] + 0.3).astype(np.float32)
    ids = np.array([3, 0, 4, 4, 1], np.int64)
    kw = dict(jitter_sigma=0.01 if jitter else 0.0, jitter_clip=0.02 if jitter else 0.0, resample=resample,
              rotate=rotate, translate=translate)
    want = native.assemble_batch_aug(clouds, ids, 129, 2**61 + 12345, **kw)
    assert want is not None, 'the native library did not build'
    got = sampler.plain(clouds, ids, 129, 2**61 + 12345, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert sampler.assemble_batch_aug('cpu', clouds, ids, 129, 2**61 + 12345, **kw)[0].tobytes() == got[0].tobytes()


def test_assembler_refuses_bad_ids():
    from pccf_torch.data import sampler

    with pytest.raises(ValueError, match='out of range'):
        sampler.plain(np.zeros((2, 4, 3), np.float32), np.array([2]), 4, 0)


# ----------------------------------------------------- the widened kernels


@pytest.mark.parametrize('n_heads', [2, 1])
def test_attention_past_128_wide_matches_jax(n_heads, monkeypatch):
    """The W-encoder at d = 512 with heads of 256 and 512: the port's stack
    (its plain version on the CPU) against JAX's XLA layers."""
    from pccf.nn import w_networks as jw
    from pccf.nn.layers import gelu_exact
    from pccf_torch.kernels import wformer
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact as tgelu
    from test_torch_port_modules import load_port
    from test_torch_port_wformer import randomize_params

    t, d, e, z1 = 128, 512, 4, 8
    assert wformer.supported(t, d, n_heads)
    jnet = jw.TransformerWEncoder(z1_dim=z1, n_codes=t, proj_dim=d, n_heads=n_heads, mlp_dims=(256,),
                                  dropout_rates=(0.0,), act=gelu_exact)
    x = np.random.default_rng(n_heads).standard_normal((2, t, e)).astype(np.float32)
    v = randomize_params(jnet.init(jax.random.key(n_heads), jnp.asarray(x)), n_heads)
    port = load_port(tw.TransformerWEncoder(e, z1, t, d, n_heads, (256,), tgelu), v)
    with japi.force_backend('jnp'):
        want = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    calls = []
    real = wformer.plain_encoder
    monkeypatch.setattr(wformer, 'plain_encoder', lambda *a: calls.append(a[2]) or real(*a))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert calls == [n_heads]
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize('conv_dims', [(256, 128, 64, 32, 16), (256, 128, 64, 32, 16, 8)])
def test_pcgen_five_and_six_layers_match_jax(conv_dims):
    from pccf.nn.decoders import PCGenDecoder
    from pccf_torch.kernels import pcgen
    from pccf_torch.nn.decoders import PCGenDecoder as TDec
    from pccf_torch.nn.layers import relu
    from test_torch_port_modules import load_port, randomize_stats

    spec = dict(w_dim=128, sample_dim=4, n_components=2, map_dims=(8,), conv_dims=conv_dims, tau=5.0)
    rng = np.random.default_rng(len(conv_dims))
    w = rng.standard_normal((2, 128)).astype(np.float32)
    samp = rng.standard_normal((2, 256, 4)).astype(np.float32)
    dec = PCGenDecoder(**spec, act=jax.nn.relu, act_name='ReLU', filtering=False)
    v = dec.init({'params': jax.random.key(0), 'sampling': jax.random.key(1)}, jnp.asarray(w), 256,
                 jnp.asarray(samp), train=False)
    v = randomize_stats(v, len(conv_dims))
    port = load_port(TDec(**spec, act=relu), v)
    assert port.fused_ok() and pcgen.supported(256, 128, conv_dims, 2) and not pcgen.flagship(8, (128, *conv_dims), 2)
    with japi.force_backend('jnp'):
        want = np.asarray(dec.apply(v, jnp.asarray(w), 256, jnp.asarray(samp), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(w), torch.from_numpy(samp)).numpy()
    np.testing.assert_allclose(got, want, **FP32)

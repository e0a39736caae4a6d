"""The data-parallel entry points of pccf_torch on the CPU, against the JAX
package where it has them.

The three training stages' entry points with ``user.cpu=true
user.n_subprocesses=2`` through the launcher against the one-rank runs; the launcher's refusals (more ranks than
cards, a failing rank); ``user.n_subprocesses`` in the configuration with
JAX's divisibility check; and the data-parallel server over
``['cpu', 'cpu']`` against JAX's server on ``get_mesh(2)`` of the conftest's
virtual devices and against the single-device server, in float32 and under
the bf16 cast.

Tolerances: the entry points' weights after an epoch of three steps rel-L2
1e-3 per tensor (AdamW's first steps move an element by about
``lr · sign(g)``, so an element whose gradient is within rounding of zero may
move the other way on one side; the classifier's final_conv BatchNorm shift,
whose gradient is rounding, within 1e-6 of its start, the attention key
biases, whose gradient is rounding too, within 2 lr a step); the server at tests/test_torch_port_cast.py's
against JAX (codes, then the clouds of agreeing codes, logits 1e-3) and at
tests/test_torch_port_slice.py's batch invariance, 1e-5, against the
single-device server (a replica runs half the bucket).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.data.structures import Inputs
from pccf_torch.dist import launch

from tests import torch_dist_ranks as ranks
from tests.test_torch_port_slice import pair  # noqa: F401  (the flax VQ-VAE and classifier, and the port's)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPOCH_REL_L2 = 1e-3
# the classifier's final_conv BatchNorm shift: its gradient is zero but for
# rounding (tests/test_torch_port_dist.py)
ZERO_GRADIENT = 'classifier.final_conv.bn.bias'
W_LR, W_STEPS = 0.0014, 3  # stage 2's learning rate (before its warmup) and TINY's steps an epoch
BATCH_INVARIANCE = dict(rtol=1e-5, atol=1e-5)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(np.asarray(b)) + 1e-30))


@pytest.fixture()
def exp_root(tmp_path, monkeypatch):
    from pccf_torch.data.protocols import Singleton

    Singleton.reset_all()
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    yield tmp_path / 'exp'
    Singleton.reset_all()


def test_entry_points_on_two_ranks_match_one(exp_root):
    """The classifier, stage 1 (``python -m pccf_torch.train.autoencoder``)
    and stage 2 from their entry points with ``user.cpu=true
    user.n_subprocesses=2``, one epoch each: the launcher's
    two gloo ranks end at the one-rank runs' weights (stage 2 loads the
    two-rank stages' checkpoints and saves the merged VQ-VAE); rank 0 wrote
    the experiment."""
    from test_pipeline import TINY
    from pccf_torch.config import paths
    from pccf_torch import cli
    from pccf_torch.train import autoencoder, classifier, w_autoencoder

    base = [*TINY, 'user.cpu=true', 'autoencoder.train.n_epochs=1']
    ones = {}
    for stage in (classifier, autoencoder, w_autoencoder):
        ones[stage] = stage.main(base)
        if stage is autoencoder:  # as a user runs it: the ranks import the stage by the module's name
            subprocess.run([sys.executable, '-m', 'pccf_torch.train.autoencoder', *base, 'user.n_subprocesses=2'],
                           cwd=ROOT, check=True, capture_output=True, timeout=600)
        else:
            assert stage.main([*base, 'user.n_subprocesses=2']) is None
    exp = paths().version_dir / cli.parse_args([*base, 'user.n_subprocesses=2'])[0].name
    assert (exp / 'config.json').exists()
    for model, want in (('DGCNN', ones[classifier]['trainer'].model.state_dict()),
                        ('VQVAE', ones[w_autoencoder]['vqvae'].state_dict())):
        saved = torch.load(exp / f'models/{model}/checkpoints/epoch_1', weights_only=True)['state_dict']
        assert set(saved) == set(want), model
        for name, value in want.items():
            diff = np.abs(saved[name].numpy() - value.numpy()).max()
            if name == ZERO_GRADIENT:  # within rounding of its start, 0, on both sides
                assert diff <= 1e-6, (model, name)
            elif name.endswith('key.bias'):  # AdamW moves it by about lr x the sign of rounding
                assert diff <= 2 * W_LR * W_STEPS, (model, name)
            else:
                assert _rel_l2(saved[name].numpy(), value.numpy()) <= EPOCH_REL_L2, (model, name)


def test_launcher_refuses_more_ranks_than_cards(monkeypatch):
    """On the card, more ranks than cards raise before any rank starts; a
    rank that fails fails the launch."""
    from pccf_torch.dist import DistributedWorker

    cfg = tc.SliceConfig()
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='Requested 2 devices but only 1'):
        DistributedWorker(ranks.fail_on_rank_one, 2).spawn(cfg)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):  # rank 1's, or rank 0's lost peer
        launch(ranks.fail_on_rank_one, 2, 'gloo', cfg)


def test_config_refuses_indivisible_batches():
    """``user.n_subprocesses`` reaches every stage's train configuration;
    a global batch it does not divide raises with JAX's message."""
    from pccf_torch import cli

    cfg, _ = cli.get_config(['user.n_subprocesses=2'])
    for t in (cfg.classifier.train, cfg.autoencoder.train, cfg.w_autoencoder.train):
        assert t.n_subprocesses == 2 and t.batch_size_per_device == t.batch_size // 2
    want = get_config_all(['user.n_subprocesses=2'])
    assert (want.autoencoder.train.batch_size_per_device, want.classifier.train.batch_size_per_device) == \
        (cfg.autoencoder.train.batch_size_per_device, cfg.classifier.train.batch_size_per_device)
    with pytest.raises(Exception, match='not divisible by number of devices 3') as jax_err:
        get_config_all(['user.n_subprocesses=3'])
    with pytest.raises(ValueError, match='not divisible by number of devices 3') as err:
        cli.get_config(['user.n_subprocesses=3'])
    assert str(err.value) in str(jax_err.value)


# ------------------------------------------------------------------ server


@pytest.mark.parametrize('cast_bf16', [False, True], ids=['f32', 'bf16'])
def test_server_over_devices_matches_jax_mesh(cast_bf16, pair):
    """``CounterfactualServer(devices=['cpu', 'cpu'])`` (two replicas, each
    bucket's rows split between them) against JAX's server on
    ``get_mesh(2)`` and against the single-device server: counterfactuals
    (the JAX server's scaffold handed to the port), classification and
    generation."""
    from pccf.dist import get_mesh
    from pccf.serve import CounterfactualServer as JServer
    from pccf.train import Model
    from pccf_torch.serve import CounterfactualServer

    from tests.test_torch_port_cast import CODE_AGREEMENT, RECON_REL_L2, SEED, _jax_sampling

    (jcls, vcls, jvq, vvq), (pcls, pvq), (clouds, _) = pair
    jsrv = JServer(Model(jvq, 'vq', variables=vvq), Model(jcls, 'cls', variables=vcls), buckets=(2, 4),
                   cast_bf16=cast_bf16, seed=SEED, mesh=get_mesh(2))
    dp = CounterfactualServer(pvq, pcls, buckets=(2, 4), seed=SEED, cast_bf16=cast_bf16, devices=['cpu', 'cpu'])
    single = CounterfactualServer(pvq, pcls, buckets=(2, 4), seed=SEED, cast_bf16=cast_bf16)
    assert len(dp.replicas) == 2 and dp.replicas[0][0] is not dp.replicas[1][0] and dp.vqvae is not pvq
    clouds3 = np.concatenate([clouds, clouds[:1] * 0.9])
    logits = np.asarray([[0.3, -0.2], [-1.0, 0.5], [0.1, 0.2]], np.float32)
    seeds = np.asarray([5, 6, 7])
    for srv in (dp, single):
        srv.initial_sampling = lambda s: _jax_sampling(np.asarray(s))
    want = jsrv.counterfactual(clouds3, np.asarray([1, 0, 1]), logits, 1.0, seeds)
    got = dp.counterfactual(clouds3, np.asarray([1, 0, 1]), logits, 1.0, seeds)
    np.testing.assert_allclose(got, single.counterfactual(clouds3, np.asarray([1, 0, 1]), logits, 1.0, seeds),
                               **BATCH_INVARIANCE)
    with torch.inference_mode():
        pout = single.vqvae.generate_counterfactual(
            Inputs(cloud=torch.from_numpy(clouds3), initial_sampling=_jax_sampling(seeds)),
            torch.from_numpy(logits), torch.tensor([1, 0, 1]), torch.ones((3, 1)))
    with japi.force_backend('jnp'):
        jout = jsrv._vq_module.apply(jsrv._vq_vars, JInputs(cloud=jnp.asarray(clouds3),
                                                            initial_sampling=jnp.asarray(_jax_sampling(seeds).numpy())),
                                     jnp.asarray(logits), jnp.asarray([1, 0, 1]), jnp.ones((3, 1)),
                                     method='generate_counterfactual')
    idx, jidx = pout.idx.numpy(), np.asarray(jout.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    for i in np.nonzero(same)[0]:
        assert _rel_l2(got[i], want[i]) <= RECON_REL_L2
    np.testing.assert_allclose(dp.classify(clouds3), single.classify(clouds3), **BATCH_INVARIANCE)
    np.testing.assert_allclose(dp.classify(clouds3), jsrv.classify(clouds3), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dp.generate(3, seed=2), single.generate(3, seed=2), **BATCH_INVARIANCE)
    assert dp.stats == single.stats


def test_server_refuses_indivisible_buckets(pair):
    """Buckets the device count does not divide raise (``serve.py:117-121``)."""
    from pccf_torch.serve import CounterfactualServer

    _, (pcls, pvq), _ = pair
    with pytest.raises(ValueError, match=r'buckets \[2, 6\] are not divisible by the 4 devices'):
        CounterfactualServer(pvq, pcls, buckets=(2, 4, 6, 8), devices=['cpu'] * 4)

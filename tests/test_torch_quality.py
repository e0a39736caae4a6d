"""The port's quality tools (``pccf_torch/tools/``) on the CPU, at
``--smoke``'s tiny widths:

- ``quality_run --smoke --cpu`` at epochs 1 / 1 / 1 writes a record with
  every key of the JAX tool's (``tools/quality_run.py``; the committed
  ``QUALITY_r5c.json``'s among them), read from the stages' return values;
  ``--stage2-only`` and ``--eval-only`` resume from its tag's checkpoints (the
  evaluation of the same checkpoints gives the same suites);
- ``cf_anatomy``'s four channel modes on the JAX model's weights, converted,
  against the JAX tool's ``cf_variant`` on the same clouds, logits and decoder
  sampling: the code indices equal and the clouds within 1e-4 (float32
  through the stacks and PCGen), and ``full`` bit-equal to the port's own
  ``generate_counterfactual`` (the same nets one by one on the CPU);
- one ``bn_ab --smoke --cpu`` pair of arms, each in its subprocess.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf_torch.tools import bn_ab, cf_anatomy, quality_run

from tests.test_torch_port_modules import load_port, randomize_stats

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_ARGS = ['--smoke', '--cpu', '--epochs-cls', '1', '--epochs-ae', '1', '--epochs-wae', '1', '--n-train', '16',
              '--n-test', '8']
CF_RTOL = CF_ATOL = 1e-4
# the record's keys that tools/quality_run.py writes (its `record`, `stage`
# and `_scrape_eval`), each a path of nested keys; misclassified_overall too
# where a test cloud is misclassified
JAX_KEYS = {
    ('tag',), ('exp_dir',),
    *(('config', k) for k in ('n_classes', 'variability', 'n_train', 'n_test', 'points', 'epochs', 'c_kld',
                              'batch_sizes', 'objective_deviates_from_reference')),
    *(('stages', s, 'wall_s') for s in ('classifier', 'autoencoder', 'w_autoencoder', 'evaluate')),
    ('stages', 'autoencoder', 'final_test_chamfer'), ('stages', 'autoencoder', 'final_test_emd'),
    ('stages', 'w_autoencoder', 'final_loss'),
    *(('stages', 'w_autoencoder', 'final_klds', k) for k in ('KLD1', 'KLD2', 'MSE', 'Quantisation Accuracy')),
    *(('stages', 'evaluate', k) for k in ('original_metrics', 'suites', 'counterfeit_overall')),
}


def _paths(tree, prefix=()):
    """Every path of nested keys, not into the suites and metric dicts."""
    out = set()
    for k, v in tree.items():
        out.add((*prefix, k))
        if isinstance(v, dict) and k not in ('suites', 'original_metrics', 'counterfeit_overall',
                                             'misclassified_overall'):
            out |= _paths(v, (*prefix, k))
    return out


@pytest.fixture()
def exp_env(tmp_path, monkeypatch):
    from pccf_torch.data.protocols import Singleton

    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    yield tmp_path
    Singleton.reset_all()


def test_quality_run_smoke_and_resumes(exp_env):
    record = quality_run.main([*SMOKE_ARGS, '--tag', 'smoke', '--out', str(exp_env / 'q.json')])
    assert json.loads((exp_env / 'q.json').read_text()) == record
    paths = _paths(record)
    assert JAX_KEYS <= paths, JAX_KEYS - paths
    assert set(quality_run.RECORD_KEYS) == JAX_KEYS and quality_run.missing_keys(record) == []
    assert _paths(json.loads((ROOT / 'QUALITY_r5c.json').read_text())) <= paths
    ev = record['stages']['evaluate']
    suites = {'ClassificationOriginal', 'ClassificationReconstructed', *(f'Counterfeit_to_{j}' for j in range(4))}
    assert suites <= set(ev['suites']) and ev['original_metrics'] == ev['suites']['ClassificationOriginal']
    assert 0.0 <= ev['counterfeit_overall']['Accuracy'] <= 1.0
    transitions = [name for name in ev['suites'] if '_to_' in name and not name.startswith('Counterfeit')]
    assert ('misclassified_overall' in ev) == bool(transitions)
    assert record['config']['objective_deviates_from_reference'] and record['config']['epochs'] == [1, 1, 1]
    assert np.isfinite(record['stages']['autoencoder']['final_test_chamfer'])
    ckpt = pathlib.Path(record['exp_dir']) / 'v0.1.0' / 'smoke' / 'models'
    assert {p.name for p in ckpt.iterdir()} == {'DGCNN', 'VQVAE'}

    stage2 = quality_run.main([*SMOKE_ARGS, '--tag', 'smoke', '--stage2-only', '--out', str(exp_env / 's.json')])
    assert list(stage2['stages']) == ['w_autoencoder', 'evaluate']
    assert set(stage2['stages']['w_autoencoder']['final_klds']) == {'KLD1', 'KLD2', 'MSE', 'Quantisation Accuracy'}
    evaluated = quality_run.main([*SMOKE_ARGS, '--tag', 'smoke', '--eval-only', '--out', str(exp_env / 'e.json')])
    assert list(evaluated['stages']) == ['evaluate']
    # the evaluation of stage 2's saved checkpoints, again: the same suites
    assert evaluated['stages']['evaluate']['suites'] == stage2['stages']['evaluate']['suites']


def test_quality_run_refuses_two_resumes():
    with pytest.raises(SystemExit):
        quality_run.main([*SMOKE_ARGS, '--eval-only', '--stage2-only'])


@pytest.fixture(scope='module')
def cf_pair():
    """The smoke widths' VQ-VAE built by the JAX package from a seed and
    converted, with clouds, logits and the decoder's sampling."""
    from pccf.config import get_config_all
    from pccf.data.structures import Inputs as JInputs
    from pccf.models import get_autoencoder
    from pccf_torch import cli
    from pccf_torch.models import build_vqvae

    overrides = [*quality_run.overrides(quality_run.parse(SMOKE_ARGS))]
    jcfg = get_config_all(overrides)
    pcfg, _ = cli.get_config(overrides)
    rng = np.random.default_rng(0)
    n = pcfg.data.n_input_points
    clouds = (rng.standard_normal((3, n, 3)) / 2).astype(np.float32)
    sampling = rng.standard_normal((3, n, pcfg.autoencoder.decoder.sample_dim)).astype(np.float32)
    logits = rng.standard_normal((3, 4)).astype(np.float32) * 2
    jvq = get_autoencoder(jcfg)
    init = jax.jit(lambda rngs, inputs, lg: jvq.init(rngs, inputs, lg, method='full_init'))
    v = init({'params': jax.random.key(2), 'sampling': jax.random.key(3)}, JInputs(cloud=jnp.asarray(clouds)),
             jnp.zeros((3, 4)))
    v = randomize_stats(v, seed=2)
    return (jvq, v), load_port(build_vqvae(pcfg), v), (clouds, sampling, logits)


@pytest.mark.parametrize('mode', range(len(cf_anatomy.MODES)))
def test_cf_anatomy_modes_match_jax(cf_pair, mode):
    from pccf.data.structures import Inputs as JInputs
    from pccf.kernels import api as japi
    from pccf_torch.data.structures import Inputs
    from tools.cf_anatomy import cf_variant

    (jvq, v), pvq, (clouds, sampling, logits) = cf_pair
    for target in range(4):
        with japi.force_backend('jnp'):
            want = jvq.apply(v, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)),
                             jnp.asarray(logits), target, 1.0, mode, method=cf_variant)
        with torch.no_grad():
            got = cf_anatomy.cf_variant(pvq, Inputs(torch.from_numpy(clouds), None, torch.from_numpy(sampling)),
                                        torch.from_numpy(logits), target, 1.0, mode)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(got.w_recon.numpy(), np.asarray(want.w_recon), rtol=CF_RTOL, atol=CF_ATOL)
        np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon), rtol=CF_RTOL, atol=CF_ATOL)
        if cf_anatomy.MODES[mode] == 'full':
            with torch.no_grad():
                served = pvq.generate_counterfactual(
                    Inputs(torch.from_numpy(clouds), None, torch.from_numpy(sampling)), torch.from_numpy(logits),
                    target, 1.0)
            assert torch.equal(served.recon, got.recon) and torch.equal(served.idx, got.idx)


def test_bn_ab_smoke_pair(tmp_path, monkeypatch):
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    results = bn_ab.main(['--smoke', '--cpu', '--epochs', '1', '--n-train', '16', '--n-test', '8',
                          '--root', str(tmp_path)])
    assert set(results) == {'g1', 'g8'}
    for g, rec in results.items():
        assert 'error' not in rec, rec
        assert rec['groups'] == int(g[1:]) and 0.0 <= rec['classifier_test_accuracy'] <= 1.0
        assert np.isfinite(rec['final_test_chamfer']) and np.isfinite(rec['final_test_emd'])
    assert json.loads((tmp_path / 'bn_ab_results.json').read_text()) == results

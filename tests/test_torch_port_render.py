"""Rendering, the reconstruction logs and the figures of the port on the CPU.

- ``pccf_torch/utils/visualization.py`` against ``pccf/utils/visualization.py``
  on the same clouds: the rasteriser's RGBA image, the HTML viewer, the PNG
  and ``confusion_matrix`` bit-equal; without matplotlib the port writes the
  viewer and no PNG, with a log line.
- ``visualize_counterfactuals``' clouds and probabilities of one sample against
  the JAX script's calls (its ``_probs``, the VQ-VAE's forward, the double
  reconstruction and one counterfactual a class) on
  ``tests/test_torch_port_slice.py``'s pair, the decoder sampling and the
  posterior's noise handed to JAX; then the entry point, ``generate``'s
  rendering and the classifier's figure at ``tests/test_pipeline.py``'s
  ``TINY`` from the port's own checkpoints, and the two plot entry points
  against JAX's on one study storage.
- ``TensorBoardLogReconstruction`` and the classifier's confusion figure write
  their events where tensorboardX imports; the hooks and the figure skip
  where their tracker or package is missing.

Tolerances: the probabilities 1e-4 (float32 logits through softmax); a
cloud's rel-L2 5e-3, ``RECON_REL_L2`` of the generation parity tests (graph
filtering's neighbours may swap at a distance near-tie).
"""

import logging
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.data.structures import Inputs as JInputs
from pccf.kernels import api as japi
from pccf.train import Model
from pccf.utils import visualization as jvis
from pccf_torch import cli
from pccf_torch.data.protocols import Singleton
from pccf_torch.data.structures import Inputs
from pccf_torch.utils import visualization as pvis
from test_pipeline import TINY

from tests.test_torch_port_slice import N_POINTS, pair  # noqa: F401 (a fixture)
from tests.test_torch_port_wformer import fixed_gaussian_sample

torch.set_num_threads(1)

CPU = [*TINY, 'user.cpu=true']
PROBS = dict(rtol=1e-4, atol=1e-4)
RECON_REL_L2 = 5e-3


def _clouds(n, points, seed):
    return [np.random.default_rng(seed + i).standard_normal((points, 3)) / 2 for i in range(n)]


@pytest.mark.parametrize('n,colorscale,arrows', [(1, 'sequence', False), (3, 'blue_red', True)])
def test_rasterize_and_viewer_are_bit_equal_to_jax(tmp_path, n, colorscale, arrows):
    clouds = _clouds(n, 40, 1)
    colors = pvis._cloud_colors(n, colorscale)
    radii = [np.asarray(0.02) for _ in clouds]
    if arrows:
        pts, rads = pvis._arrows_to_spheres(clouds[0], clouds[1] - clouds[0], 0.02)
        jpts, jrads = jvis._arrows_to_spheres(clouds[0], clouds[1] - clouds[0], 0.02)
        assert np.array_equal(pts, jpts) and np.array_equal(rads, jrads)
        clouds, colors, radii = clouds + [pts], colors + [pvis.RED], radii + [rads]
    got = pvis._rasterize(clouds, colors, radii, size=96)
    want = jvis._rasterize(clouds, colors, radii, size=96)
    assert got.shape == (96, 96, 4) and got[..., 3].any() and np.array_equal(got, want)
    names = ['a</script>', 'b', 'c', 'd'][: len(clouds)]
    p = pvis.write_html_viewer(clouds, colors, 'T <x>', tmp_path / 'port.html', names)
    j = jvis.write_html_viewer(clouds, colors, 'T <x>', tmp_path / 'jax.html', names)
    assert p.read_text() == j.read_text()


def test_render_cloud_files_equal_jax(tmp_path):
    clouds = _clouds(2, 30, 5)
    kw = dict(colorscale='blue_red', interactive=True, title='Counterfactual to 1: (0.25 0.75)', size=64)
    got = pvis.render_cloud(clouds, save_dir=tmp_path / 'port', **kw)
    want = jvis.render_cloud(clouds, save_dir=tmp_path / 'jax', **kw)
    assert got.name == want.name == 'Counterfactual_to_1_0.25_0.75_.png'
    for name in (got.name, got.with_suffix('.html').name):
        assert (tmp_path / 'port' / name).read_bytes() == (tmp_path / 'jax' / name).read_bytes(), name


def test_confusion_matrix_equals_jax():
    rng = np.random.default_rng(3)
    predictions, labels = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    got = pvis.confusion_matrix(predictions, labels, 4)
    assert np.array_equal(got, jvis.confusion_matrix(predictions, labels, 4)) and got.sum() == 50


def test_render_cloud_without_matplotlib_writes_the_viewer(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with caplog.at_level(logging.WARNING):
        out = pvis.render_cloud(_clouds(1, 20, 2), title='0', save_dir=tmp_path)
    assert out == tmp_path / '0.html' and out.is_file()
    assert sorted(p.name for p in tmp_path.iterdir()) == ['0.html']
    assert 'matplotlib is not installed' in caplog.text
    with pytest.raises(ImportError):
        pvis.plot_confusion_matrix_heatmap(np.eye(2, dtype=int), ['a', 'b'])


def test_visualized_sample_matches_the_jax_script(pair, monkeypatch, capsys):  # noqa: F811
    """One sample's clouds through the port's ``sample_clouds`` and through the
    calls of ``visualize_counterfactuals.py:48-71`` on the same weights."""
    import visualize_counterfactuals as jscript
    from pccf_torch import visualize_counterfactuals as pscript

    (jcls, vcls, jvq, vvq), (pcls, pvq), (clouds, _) = pair
    cloud = clouds[:1]
    sampling, eps = pscript.draws(pvq, torch.Generator().manual_seed(0))
    got = pscript.sample_clouds(pcls.eval(), pvq.eval(), Inputs(cloud=torch.from_numpy(cloud)), 0.8, 2, sampling,
                                eps)
    printed = capsys.readouterr().out
    jc, jv = Model(jcls, 'cls', variables=vcls), Model(jvq, 'vq', variables=vvq)
    sample = JInputs(cloud=jnp.asarray(cloud), initial_sampling=jnp.asarray(sampling.numpy()))
    fixed_gaussian_sample(monkeypatch, [e.numpy() for e in eps])
    with japi.force_backend('jnp'):
        logits, _ = jscript._probs(jc, cloud, 'Original')
        want = [cloud[0], np.asarray(jv.apply(sample).recon)[0],
                np.asarray(jv.apply(sample, logits, method='double_reconstruct_with_logits').recon)[0]]
        for j in range(2):
            want.append(np.asarray(jv.apply(sample, logits, np.int32(j), np.float32(0.8),
                                            method='generate_counterfactual').recon)[0])
        want_probs = [np.asarray(jax.nn.softmax(jc(JInputs(cloud=jnp.asarray(c[None]))), axis=1))[0] for c in want]
    assert [g[0] for g in got] == ['original', 'reconstruction', 'double_reconstruction', 'counterfactual_0',
                                   'counterfactual_1']
    for (name, c, probs, text, _), w, wp in zip(got, want, want_probs):
        assert c.shape == (N_POINTS, 3) and text in printed
        np.testing.assert_allclose(probs, wp, err_msg=name, **PROBS)
        assert float(np.linalg.norm(c - w) / np.linalg.norm(w)) <= RECON_REL_L2, name


@pytest.fixture()
def exp_root(tmp_path, monkeypatch):
    Singleton.reset_all()
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    yield tmp_path / 'exp'
    Singleton.reset_all()


def _events(exp_dir):
    return b''.join(p.read_bytes() for p in (exp_dir / 'tb').rglob('*') if p.is_file())


def test_entry_points_render_and_log_at_tiny(exp_root, capsys):
    """The stages with TensorBoard on (a reconstruction logged every epoch),
    then ``visualize_counterfactuals`` and ``generate`` render their clouds."""
    from pccf_torch import generate, visualize_counterfactuals
    from pccf_torch.config import paths
    from pccf_torch.train import autoencoder, classifier, w_autoencoder

    args = [*CPU, 'user.trackers.tensorboard=true', 'autoencoder.train.learn.scheduler.restart_interval=1']
    cfg = cli.parse_args(args)[0]
    exp = paths().version_dir / cfg.name
    # each stage's events are read before the next starts: a writer opened in
    # the same second may take the same event file name
    classifier.main(args)
    events = _events(exp)
    for tag in (b'DGCNN/FinalTest-Confusion', b'DGCNN/FinalTest-Misclassified', b'Total misclassified samples: '):
        assert tag in events, tag
    autoencoder.main(args)
    events = _events(exp)
    for tag in (b'Sample 0 with label: 0', b'Recon 0'):
        assert tag in events, tag
    w_autoencoder.main(args)
    capsys.readouterr()
    out = visualize_counterfactuals.main(args)
    printed = capsys.readouterr().out
    assert sorted(out) == [0, 1] and 'Sample 1 with label' in printed and 'Counterfactual to 1: (' in printed
    images = paths().version_dir / 'images' / cfg.name
    for i in (0, 1):
        files = sorted(p.name for p in (images / f'sample_{i}').iterdir())
        assert 'Counterfactuals.png' in files and len(files) >= 2
        assert all(np.isfinite(c).all() and c.shape == (64, 3) for _, c, *_ in out[i])
    again = visualize_counterfactuals.main(args)
    assert all(np.array_equal(a[1], b[1]) for i in (0, 1) for a, b in zip(out[i], again[i]))
    clouds = generate.main(args)
    assert sorted(p.name for p in (images / 'generated').iterdir()) == [f'{i}.png' for i in range(len(clouds))]


def test_hooks_and_figures_skip_without_their_packages(exp_root, monkeypatch, caplog):
    from pccf_torch.experiment import Experiment
    from pccf_torch.train import classifier, hooks, trackers

    cfg = cli.parse_args(CPU)[0]
    with Experiment(cfg).create_run(record=False):
        with pytest.raises(trackers.TrackerNotUsedError):
            hooks.TensorBoardLogReconstruction(None)
        with pytest.raises(trackers.TrackerNotUsedError):
            trackers.WandbTracker.require_current()
        monkeypatch.setitem(sys.modules, 'wandb', None)
        with pytest.raises(ImportError):
            hooks.WandbLogReconstruction(None)
        with caplog.at_level(logging.INFO, logger='pccf_torch'):
            assert not classifier.log_confusion(np.eye(2, dtype=int), ['0', '1'], 'DGCNN', 'FinalTest', [], '[]', 1)
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    cfg_tb = cli.parse_args([*CPU, 'user.trackers.tensorboard=true'])[0]
    with caplog.at_level(logging.INFO, logger='pccf_torch'):
        assert not any(isinstance(t, trackers.TensorBoardTracker) for t in trackers.get_trackers(cfg_tb))
    assert 'tensorboardX unavailable' in caplog.text and 'confusion-matrix figure skipped' in caplog.text


@pytest.mark.parametrize('tree,group', [('autoencoder', 'decoder'), ('w_autoencoder', 'w_decoder')])
def test_plot_entry_points_draw_what_jax_draws(tmp_path, monkeypatch, tree, group):
    """A study of three trials written by the port's engine, then the port's
    and JAX's plot entry points over its storage: the same files."""
    import importlib

    from pccf_torch import tuning as pt

    root = cli.DEFAULT_CONFIG_DIR.parents[0] / 'tuning' / tree
    argv = [f'db_location={tmp_path}']
    monkeypatch.setattr(pt, 'visualize_study', lambda study, save_dir, renderer='': [])
    pt.run_study(root, lambda cfg: (lambda trial: len(pt.suggest_overrides(cfg, trial)) + trial.number),
                 [f'tune={group}', 'tune.n_trials=3', *argv])
    monkeypatch.undo()
    port = importlib.import_module(f'pccf_torch.plot_optimization_{group}')
    got = port.main(argv)
    assert got and all(p.is_file() for p in got)
    names = sorted(p.name for p in got)
    for p in got:
        p.unlink()
    script = importlib.import_module(f'plot_optimization_{group}')
    monkeypatch.setattr(sys, 'argv', ['plot', *argv])
    script.main()
    assert sorted(p.name for p in got[0].parent.iterdir() if p.is_file()) == names


@pytest.mark.parametrize('overrides', [[], ['user.plot.interactive=true', 'user.plot.sample_indices=[3,1]']])
def test_plot_config_matches_jax(overrides):
    """``user.plot`` read from the tree as ``pccf/config/specs.py``'s
    ``PlottingOptions`` reads it; a negative index refused."""
    from pccf.config import get_config_all

    want = get_config_all(overrides).user.plot
    got = cli.get_config(overrides)[0].user.plot
    assert (got.interactive, list(got.sample_indices)) == (want.interactive, list(want.sample_indices))
    with pytest.raises(ValueError, match='non-negative'):
        cli.get_config(['user.plot.sample_indices=[-1]'])

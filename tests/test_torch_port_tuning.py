"""The port's study engine and tuning entry points against the JAX
package's, on the CPU.

``pccf_torch.tuning`` is a copy of ``pccf/utils/tuning.py``; on the same
seeds the two give the same suggestions (random, TPE and GP samplers, every
distribution kind), the same ``suggest_overrides`` for every space of
``configs/tuning/**/tune``, the same median-pruner decisions, imputations
and study names, and each reads the other's sqlite storage.  Then the
port's own parts: the trial callback on the port's trainer, the plots
without matplotlib, ``run_study`` over the tuning tree, two trials of
``tune_autoencoder`` (and one of an architecture space) and two of
``tune_w_autoencoder`` at a tiny width, and the frozen-outer graft of
``tests/test_tune_graft.py`` on the port's ``state_dict``.  Exact equality
throughout: the engines run the same numpy arithmetic.
"""

import math
import pathlib
import sqlite3
import sys
import types

import numpy as np
import pytest
import torch

from pccf.config.compose import compose as jax_compose
from pccf.utils import tuning as jt
from pccf_torch import tuning as pt
from pccf_torch.compose import compose
from pccf_torch.data.protocols import Singleton
from test_pipeline import TINY

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPACES = sorted(str(p.relative_to(ROOT / 'configs' / 'tuning')) for p in (ROOT / 'configs' / 'tuning').rglob(
    'tune/*.yaml'))
CPU = [*TINY, 'user.cpu=true']


def _study(engine, tmp_path, name, sampler, **kw):
    return engine.create_study(name, f'sqlite:///{tmp_path}/{engine.__name__.replace(".", "_")}.db', sampler=sampler,
                               **kw)


def _objective(engine):
    """A deterministic function of every distribution kind, reporting five
    steps and asking the pruner after each."""
    def objective(trial):
        x = trial.suggest_float('x', 1e-3, 1.0, log=True)
        y = trial.suggest_float('y', -2.0, 2.0)
        n = trial.suggest_int('n', 1, 9)
        m = trial.suggest_int('m', 2, 64, log=True)
        c = trial.suggest_categorical('c', ['a', 'b', 'c'])
        value = (math.log(x) + 3) ** 2 + (y - 0.5) ** 2 + abs(n - 4) + abs(math.log2(m) - 3) + 'abc'.index(c)
        for step in range(5):
            trial.report(value * (1 + 1 / (step + 1)), step)
            if trial.should_prune():
                raise engine.TrialPruned()
        return value
    return objective


@pytest.mark.parametrize('kind', ['random', 'tpe', 'gp'])
def test_samplers_and_pruner_match_jax(tmp_path, kind):
    """Sixteen trials on each engine from the same seed, the samplers past
    their random start after 4 and the median pruner on after 3: the same
    parameters, states, values and reports, trial by trial."""
    studies = []
    for engine in (jt, pt):
        sampler = engine.make_sampler(kind, n_startup=4, seed=11)
        pruner = engine.MedianPruner(n_startup_trials=3, n_warmup_steps=1, n_min_trials=2)
        study = _study(engine, tmp_path, kind, sampler, pruner=pruner)
        study.optimize(_objective(engine), n_trials=16)
        studies.append(study.get_trials())
    want, got = studies
    assert [(t.number, t.state, t.value, t.params, t.intermediate_values) for t in got] == [
        (t.number, t.state, t.value, t.params, t.intermediate_values) for t in want]
    assert {t.state for t in got} >= {'COMPLETE', 'PRUNED'}


@pytest.mark.parametrize('space', SPACES)
def test_suggest_overrides_for_every_space(tmp_path, space):
    """Every space of the tuning tree composes the same through both
    readers and gives the same overrides for three trials of one seed."""
    stage, _, name = space.partition('/tune/')
    d = ROOT / 'configs' / 'tuning' / stage
    argv = [f'tune={name[:-len(".yaml")]}']
    tune_cfg = compose(d, 'defaults', argv)
    assert tune_cfg == jax_compose(d, 'defaults', argv)
    lists = []
    for engine in (jt, pt):
        study = _study(engine, tmp_path, space, engine.RandomSampler(seed=5))
        lists.append([engine.suggest_overrides(tune_cfg, engine.Trial(study, i)) for i in range(3)])
    assert lists[0] == lists[1]
    assert all(ov[0] == tune_cfg['overrides'][0] for ov in lists[1])


@pytest.mark.parametrize('direction', ['minimize', 'maximize'])
def test_imputation_matches_jax(tmp_path, direction):
    """Pruned and failed trials imputed from the completed ones (the 75th or
    25th percentile, the worst value); imputed values do not count; fewer
    than ten real ones prune."""
    out = []
    for engine in (jt, pt):
        study = _study(engine, tmp_path, direction, engine.RandomSampler(0), direction=direction)
        values = iter(np.random.default_rng(3).standard_normal(12).tolist())
        study.optimize(lambda t: next(values), n_trials=9)
        trial = engine.Trial(study, 100)
        with pytest.raises(engine.TrialPruned):
            engine.impute_pruned_trial(trial)
        study.optimize(lambda t: next(values), n_trials=3)
        pruned = engine.impute_pruned_trial(engine.Trial(study, 101))
        failed = engine.impute_failed_trial(engine.Trial(study, 102))
        imputed = engine.Trial(study, 103)
        imputed.set_user_attr('imputed', True)
        study._save_trial(imputed, engine.TrialState.COMPLETE, 1e9)
        out.append((pruned, failed, engine.impute_failed_trial(engine.Trial(study, 104))))
    assert out[0] == out[1]


def test_studies_resume_from_each_others_storage(tmp_path):
    storage = f'sqlite:///{tmp_path}/shared.db'
    a = jt.create_study('s', storage, sampler=jt.RandomSampler(1))
    a.optimize(lambda t: t.suggest_float('x', 0, 1), n_trials=3)
    b = pt.create_study('s', storage, sampler=pt.RandomSampler(2))
    assert [(t.number, t.value, t.params) for t in b.get_trials()] == [
        (t.number, t.value, t.params) for t in a.get_trials()]
    b.optimize(lambda t: t.suggest_float('x', 0, 1) + t.suggest_int('k', 0, 3), n_trials=2)
    assert [(t.number, t.state, t.value, t.params) for t in jt.create_study('s', storage).get_trials()] == [
        (t.number, t.state, t.value, t.params) for t in b.get_trials()]
    assert len(b.get_trials()) == 5 and b.best_trial.value == min(t.value for t in b.get_trials())


@pytest.mark.parametrize('overrides', [[], ['autoencoder.train.n_epochs=100'],
                                       ['data/dataset=shapenet', 'w_autoencoder.model.w_decoder.n_heads=4']])
def test_study_names_and_samplers_match_jax(overrides):
    assert pt.get_study_name('v0.1.0', 'main', 'learn', overrides) == jt.get_study_name(
        'v0.1.0', 'main', 'learn', overrides)
    for kind in ('gp', 'tpe', 'random'):
        assert type(pt.make_sampler(kind, seed=0)).__name__ == type(jt.make_sampler(kind, seed=0)).__name__
    with pytest.raises(ValueError, match='Unknown sampler'):
        pt.make_sampler('cmaes')


def test_trial_callback_reads_the_ports_trainer(tmp_path):
    """The moving average of the monitored value of the latest validation
    row (the composite recon criterion evaluated over its leaves), reported
    at the trainer's completed epoch; pruned when the pruner says so."""
    from pccf_torch.config import SliceConfig
    from pccf_torch.train.hooks import get_moving_average
    from pccf_torch.train.losses import get_recon_loss

    study = _study(pt, tmp_path, 'cb', pt.RandomSampler(0),
                   pruner=pt.MedianPruner(n_startup_trials=1, n_warmup_steps=0, n_min_trials=1))
    study.optimize(lambda t: (t.report(0.5, 1), t.report(0.01, 2), 0.01)[-1], n_trials=1)
    trial = pt.Trial(study, 1)
    callback = pt.TrialCallback(trial, get_recon_loss(SliceConfig()), filter_fn=get_moving_average())
    rows = [{'Chamfer': 0.05, 'EMD': 0.02, 'Loss': 9.0}, {'Chamfer': 0.2, 'EMD': 0.1, 'Loss': 9.0}]
    trainer = types.SimpleNamespace(validation_log=rows[:1], metrics_log=[{'Loss': 5.0}], epoch=1)
    callback(trainer)
    assert trial.intermediate_values == {1: pytest.approx(0.07)}
    trainer.validation_log, trainer.epoch = rows, 2
    with pytest.raises(pt.TrialPruned):
        callback(trainer)
    assert trial.intermediate_values[2] == pytest.approx(0.9 * 0.07 + 0.1 * 0.3)


def test_visualize_study_without_matplotlib(tmp_path, monkeypatch, caplog):
    study = _study(pt, tmp_path, 'vis', pt.RandomSampler(0))
    study.optimize(lambda t: t.suggest_float('x', 0, 1), n_trials=3)
    drawn = pt.visualize_study(study, tmp_path / 'plots')
    assert [p.name for p in drawn] == ['history.png', 'slice_x.png'] and all(p.is_file() for p in drawn)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with caplog.at_level('INFO', logger='pccf_torch'):
        assert pt.visualize_study(study, tmp_path / 'none') == []
    assert 'matplotlib' in caplog.text and not (tmp_path / 'none').exists()


def test_run_study_over_the_tuning_tree_matches_jax(tmp_path):
    """The tree ``- ../optuna`` composes with the arguments; the study named
    by the version, the fixed overrides and the space, its trials stored."""
    argv = ['tune=embedding', 'tune.n_trials=2']
    d = ROOT / 'configs' / 'tuning' / 'autoencoder'

    def set_objective(engine):
        return lambda cfg: (lambda trial: len(engine.suggest_overrides(cfg, trial)) + 0.5)

    names = []
    for engine, sub in ((jt, 'jax'), (pt, 'port')):
        study = engine.run_study(d, set_objective(engine), [*argv, f'db_location={tmp_path / sub}'])
        names.append(study.study_name)
        trials = study.get_trials()
        assert [t.state for t in trials] == ['COMPLETE'] * 2 and all(t.value == 3.5 for t in trials)
        assert sorted(trials[0].params) == ['autoencoder.model.vq_noise', 'autoencoder.objective.c_embedding']
    assert names[0] == names[1] == 'v0.1.0_main_n_epochs=100_embedding'
    with sqlite3.connect(tmp_path / 'port' / 'autoencoder_optimization.db') as db:
        assert db.execute('SELECT COUNT(*) FROM trials').fetchone() == (2,)


@pytest.fixture()
def exp_root(tmp_path, monkeypatch):
    """Temporary experiment and data directories.  The study's plots are
    drawn in a directory named after the study, whose name carries every
    fixed override; ``TINY``'s forty pass the file-name limit (in JAX's
    engine too), so the plots are left to their own test."""
    Singleton.reset_all()
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    monkeypatch.setattr(pt, 'visualize_study', lambda study, save_dir, renderer='': [])
    yield tmp_path
    Singleton.reset_all()


def _overrides(extra):
    return 'overrides=[' + ','.join(f'"{o}"' for o in [*CPU, *extra]) + ']'


def test_tune_autoencoder_at_a_tiny_width(exp_root):
    """Two trials of the learning space and one of the decoder's on the CPU:
    each trial's stage 1 reports the moving average of its validation
    Chamfer + EMD after both epochs and ends COMPLETE with it; the trials'
    checkpoints go to the 'Trial' experiment."""
    from pccf_torch import tune_autoencoder
    from pccf_torch.config import paths

    db = exp_root / 'db'
    study = tune_autoencoder.main(['tune=learn', 'tune.n_trials=2', f'db_location={db}', _overrides([])])
    trials = study.get_trials()
    assert [t.state for t in trials] == ['COMPLETE'] * 2
    for t in trials:
        assert sorted(t.intermediate_values) == [1, 2] and t.value == t.intermediate_values[2]
        assert np.isfinite(t.value) and sorted(t.params) == [
            'autoencoder.train.learn.learning_rate', 'autoencoder.train.learn.opt_settings.weight_decay',
            'autoencoder.train.learn.scheduler.warmup_steps']
    assert trials[0].params != trials[1].params
    assert (paths().version_dir / 'Trial' / 'models' / 'VQVAE' / 'checkpoints' / 'epoch_2').is_file()
    assert not (paths().version_dir / 'Trial' / 'config.json').exists()
    arch = tune_autoencoder.main(['tune=decoder', 'tune.n_trials=1', f'db_location={db}', _overrides([])])
    (t,) = arch.get_trials()
    assert t.state == 'COMPLETE' and np.isfinite(t.value) and 'autoencoder.model.decoder.conv_dims.length' in t.params
    assert (db / 'autoencoder_optimization.db').is_file()


def test_tune_w_autoencoder_at_a_tiny_width(exp_root):
    """The frozen models of the experiment the study's overrides name, two
    trials of the learning space (the gradient operation among them) over
    them: each trial's stage 2 reports after every epoch and ends COMPLETE;
    the frozen VQ-VAE is left as it was."""
    from pccf_torch import cli, tune_w_autoencoder
    from pccf_torch.experiment import Experiment
    from pccf_torch.train import autoencoder, classifier

    cfg, _ = cli.get_config(CPU)
    with Experiment(cfg).create_run():
        classifier.stage(cfg, torch.device('cpu'))
        trained = autoencoder.stage(cfg, torch.device('cpu'))['trainer'].model.state_dict()
    extra = ['w_autoencoder.train.n_epochs=2']
    study = tune_w_autoencoder.main(['tune=learn', 'tune.n_trials=2', f'db_location={exp_root / "db"}',
                                     _overrides(extra)])
    trials = study.get_trials()
    assert [t.state for t in trials] == ['COMPLETE'] * 2
    assert all(sorted(t.intermediate_values) == [1, 2] and np.isfinite(t.value) for t in trials)
    assert {'w_autoencoder.train.learn.grad_op', 'w_autoencoder.train.learn.learning_rate'} <= set(trials[0].params)
    with Experiment(cfg).create_run(record=False):
        from pccf_torch.train.checkpoint import Checkpoint
        from pccf_torch.models import build_vqvae

        reloaded = build_vqvae(cfg)
        Checkpoint(cfg.autoencoder.name).load(reloaded, -1)
    assert all(torch.equal(v, trained[k]) for k, v in reloaded.state_dict().items())


def test_graft_transfers_outer_params_and_buffers():
    """``tests/test_tune_graft.py``'s expectations on the port's
    ``state_dict``: every outer parameter and BatchNorm buffer of the
    trained model moves onto the fresh one, its inner CVAE stays fresh, and
    the two encode alike in eval."""
    from pccf_torch import cli
    from pccf_torch.data.structures import Inputs
    from pccf_torch.train import autoencoder
    from pccf_torch.tune_w_autoencoder import graft_frozen_outer, split_frozen_outer

    cfg, _ = cli.get_config(CPU)
    trained = autoencoder.build(cfg, 0)
    with torch.no_grad():
        for k, v in trained.state_dict().items():
            if v.is_floating_point():
                v += 3.5 if ('running' in k) else 1.0
    frozen = split_frozen_outer(trained)
    assert frozen and not any(k.startswith('w_autoencoder.') for k in frozen)
    assert any('running_mean' in k for k in frozen) and any('running_var' in k for k in frozen)
    fresh = autoencoder.build(cfg, 7)
    fresh_inner = {k: v.clone() for k, v in fresh.state_dict().items() if k.startswith('w_autoencoder.')}
    graft_frozen_outer(fresh, frozen)
    state = fresh.state_dict()
    assert all(torch.equal(state[k], v) for k, v in frozen.items())
    assert all(torch.equal(state[k], v) for k, v in fresh_inner.items())
    assert any(not torch.equal(v, trained.state_dict()[k]) for k, v in fresh_inner.items())
    cloud = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a = trained.eval().encode(Inputs(cloud)).w_q
        b = fresh.eval().encode(Inputs(cloud)).w_q
    assert torch.equal(a, b)

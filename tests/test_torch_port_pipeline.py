"""The port's entry points on the CPU (``user.cpu=true``), from the experiment
tree: the four stages and generation at ``tests/test_pipeline.py``'s
``TINY`` through their ``main``s, leaving JAX's directory layout, the
evaluation reading the checkpoints the stages wrote (bit-equal weights);
stage 2 under the tuning space's gradient ops; ``final=true`` turning early
stopping and validation off; the classifier's command line against
``train_classifier.py`` from the same converted initial variables, with
dropout and jitter off (per-epoch CSV metrics within 1e-4 relative, the
early-stop epoch equal); the module as a script; and the port importing
with JAX, flax, pccf, yaml and pydantic blocked.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pccf_torch import cli
from pccf_torch.config import paths
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.protocols import Singleton
from test_pipeline import TINY

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [*TINY, 'user.cpu=true']
CLI_RTOL = 1e-4  # the classifier's per-epoch metrics against JAX's, as its SGD-step test holds them


@pytest.fixture()
def exp_root(tmp_path, monkeypatch):
    Singleton.reset_all()
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    yield tmp_path / 'exp'
    Singleton.reset_all()


def _exp_dir(args):
    return paths().version_dir / cli.parse_args(args)[0].name


def test_tiny_pipeline_through_the_mains(exp_root, capsys):
    from pccf_torch import evaluate_counterfactuals, generate
    from pccf_torch.train import autoencoder, classifier, w_autoencoder

    cls_out = classifier.main(CPU)
    ae_out = autoencoder.main(CPU)
    w_out = w_autoencoder.main(CPU)
    suites = evaluate_counterfactuals.main(CPU)
    clouds = generate.main(CPU)
    exp = _exp_dir(CPU)
    assert exp.parent == exp_root / 'v0.1.0'
    files = {str(p.relative_to(exp)) for p in exp.rglob('*') if p.is_file()}
    for name in ('config.json', 'composed_config.json', 'models/DGCNN/checkpoints/epoch_1',
                 'models/DGCNN/checkpoints/epoch_1_opt', 'models/VQVAE/checkpoints/epoch_2',
                 'models/VQVAE/checkpoints/epoch_2_opt', 'metrics/DGCNN_Train.csv', 'metrics/DGCNN_Validation.csv',
                 'metrics/DGCNN_FinalTest.csv', 'metrics/VQVAE_Train.csv', 'metrics/VQVAE_FinalTest.csv',
                 'metrics/WAutoEncoder_Train.csv', 'metrics/WAutoEncoder_TestEncoding.csv',
                 'metrics/DGCNN_ClassificationOriginal.csv'):
        assert name in files, name
    assert not any('WAutoEncoder/checkpoints' in f for f in files)  # stage 2 saves the merged VQ-VAE only
    # the evaluation and generation loaded what the stages wrote: stage 2's merged VQ-VAE, the classifier
    for k, v in cls_out['trainer'].model.classifier.state_dict().items():
        assert torch.equal(w_out['classifier'].state_dict()[k], v), k
    trained, merged = ae_out['trainer'].model.state_dict(), w_out['vqvae'].state_dict()
    assert all(k.startswith('w_autoencoder.') or torch.equal(trained[k], v) for k, v in merged.items())
    saved = torch.load(exp / 'models/VQVAE/checkpoints/epoch_2', weights_only=True)['state_dict']
    assert all(torch.equal(saved[k], v) for k, v in merged.items())
    assert any(not torch.equal(v, trained[k]) for k, v in saved.items() if k.startswith('w_autoencoder.'))
    assert 'ClassificationOriginal' in suites and 'Accuracy' in suites['ClassificationOriginal']
    assert clouds.shape == (2, 64, 3) and np.isfinite(clouds).all()
    assert np.isfinite(ae_out['loss']) and np.isfinite(w_out['loss'])
    printed = capsys.readouterr().out
    assert "Confusion Matrix for classes ['0', '1']" in printed and 'label distribution' in printed
    # a server of the same checkpoints (serve.py:222-231)
    from pccf_torch.experiment import Experiment
    from pccf_torch.serve import CounterfactualServer

    cfg = cli.parse_args(CPU)[0]
    with Experiment(cfg).create_run(record=False):
        server = CounterfactualServer.from_config(cfg, 'cpu', buckets=(1, 2))
    assert all(torch.equal(server.vqvae.state_dict()[k], v) for k, v in saved.items())
    recon = server.counterfactual(clouds, np.array([1, 0]))
    assert recon.shape == (2, 64, 3) and np.isfinite(recon).all()


@pytest.mark.parametrize('grad_op', ['GradNormClipper', 'HistClipper', 'GradZScoreNormalizer'])
def test_stage2_trains_under_the_tuning_grad_ops(exp_root, grad_op):
    from pccf_torch.train import autoencoder, classifier, w_autoencoder

    classifier.main(CPU)
    autoencoder.main(CPU)
    out = w_autoencoder.main([*CPU, f'w_autoencoder.train.learn.grad_op={grad_op}', 'w_autoencoder.train.n_epochs=2'])
    trainer = out['trainer']
    assert type(trainer.grad_op).__name__ == grad_op and trainer.epoch == 2 and np.isfinite(out['loss'])
    assert all(np.isfinite(list(row.values())).all() for row in trainer.metrics_log)


def test_final_turns_early_stopping_and_validation_off(exp_root):
    from pccf_torch.train import classifier

    args = [*CPU, 'final=true', 'classifier.train.n_epochs=3', 'classifier.train.early_stopping.active=true',
            'classifier.train.early_stopping.patience=1']
    out = classifier.main(args)
    trainer = out['trainer']
    assert trainer.epoch == 3 and trainer.validation_log == [] and not trainer.post_epoch_hooks
    assert _exp_dir(args).name.endswith('_final')
    out = classifier.main([*CPU, 'classifier.train.n_epochs=2', 'classifier.train.early_stopping.active=true'])
    assert len(out['trainer'].post_epoch_hooks) == 1 and len(out['trainer'].validation_log) == 2


def test_entry_points_refuse_what_is_not_ported(exp_root, monkeypatch):
    """Data parallelism is refused; the flagship's ModelNet reader without
    its files tries the archive's download and, offline, raises with the
    manual instructions; without a card and without ``user.cpu`` an entry
    point raises."""
    import urllib.request

    from pccf_torch.train import classifier

    with pytest.raises(NotImplementedError, match='n_subprocesses'):
        classifier.main([*CPU, 'user.n_subprocesses=2'])

    def offline(url, path):
        raise OSError('no network')

    monkeypatch.setattr(urllib.request, 'urlretrieve', offline)
    with pytest.raises(FileNotFoundError, match='Download it manually'):
        classifier.main(['user.cpu=true'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        classifier.main(TINY)


def _read_csv(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def test_classifier_cli_against_jax(exp_root):
    """``train_classifier.py`` and the port's classifier ``main`` from the same
    initial variables (JAX's, converted and handed to the port as its epoch-0
    checkpoint), dropout and jitter off, early stopping at patience 1: the
    per-epoch training and validation metrics the CSV trackers wrote, and the
    epoch training stopped at."""
    from pccf.config import Experiment as JExperiment
    from pccf.config import get_config_all
    from pccf.data import Inputs as JInputs
    from pccf.data.protocols import Singleton as JSingleton
    from pccf.nn import get_classifier
    from pccf.train import get_trackers
    from pccf.train.model import Model
    from pccf_torch.train import classifier

    overrides = [*TINY, 'classifier.train.n_epochs=8', 'classifier.train.early_stopping.active=true',
                 'classifier.train.early_stopping.window=1', 'classifier.train.early_stopping.patience=1',
                 'classifier.model.dropout_rates=[0.,0.]', 'data.jitter_sigma=0', 'data.jitter_clip=0']
    JSingleton.reset_all()
    jcfg = get_config_all(overrides)
    init = Model(get_classifier(jcfg), name='DGCNN', seed=0)
    init.initialize(JInputs(cloud=np.zeros((1, jcfg.data.n_input_points, 3), np.float32)), train=False)
    variables = jax.tree.map(np.asarray, init.variables)
    jexp = JExperiment(jcfg, name='jax', par_dir=exp_root / 'jax')
    for tracker in get_trackers(jcfg):
        jexp.subscribe(tracker)
    with jexp.create_run():
        from train_classifier import train_classifier

        train_classifier()

    port_args = [*overrides, 'user.cpu=true', 'user.load_checkpoint=-1']
    ckpt = _exp_dir(port_args) / 'models' / 'DGCNN' / 'checkpoints' / 'epoch_0'
    ckpt.parent.mkdir(parents=True)
    state = {f'classifier.{k}': v for k, v in flax_to_state_dict(variables).items()}
    torch.save({'state_dict': state, 'epoch': 0}, ckpt)
    out = classifier.main(port_args)

    for source in ('Train', 'Validation'):
        want = _read_csv(exp_root / 'jax' / 'jax' / 'metrics' / f'DGCNN_{source}.csv')
        got = _read_csv(_exp_dir(port_args) / 'metrics' / f'DGCNN_{source}.csv')
        assert len(got) == len(want) == out['trainer'].epoch, source
        for g, w in zip(got, want):
            for key in w:
                if key != 'epoch_time_s':
                    np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=CLI_RTOL, atol=1e-6,
                                               err_msg=(source, g['epoch'], key))
    assert out['trainer'].epoch < 8  # early stopping ended it


def test_classifier_runs_as_a_script(exp_root):
    env = {**os.environ, 'PYTHONPATH': ROOT}
    proc = subprocess.run([sys.executable, '-m', 'pccf_torch.train.classifier', *CPU], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'Confusion Matrix' in proc.stdout
    assert (_exp_dir(CPU) / 'models' / 'DGCNN' / 'checkpoints' / 'epoch_1').is_file()


def test_port_and_chip_smoke_import_with_jax_blocked():
    """Every module of pccf_torch and chip_smoke.py import with jax, flax,
    pccf, yaml and pydantic made unimportable."""
    code = '''
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pccf', 'yaml', 'pydantic', 'optax', 'orbax'):
            raise ImportError(f'blocked: {name}')
sys.meta_path.insert(0, Block())
import pccf_torch
names = [m.name for m in pkgutil.walk_packages(pccf_torch.__path__, 'pccf_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
'''
    env = {**os.environ, 'PYTHONPATH': ROOT}
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, env=env, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 40

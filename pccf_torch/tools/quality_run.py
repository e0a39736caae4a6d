"""The four-stage quality run on the 4-class synthetic surrogate
(``tools/quality_run.py``): the classifier, the VQ-VAE, the inner CVAE, then
the five evaluation suites, at the flagship shapes (2048 points in and out,
k = 25, w_dim 1024 = 256 codes x 4, a book of 16), through the functions the
port's entry points run (``pccf_torch.train.classifier.stage``,
``train.autoencoder.stage``, ``train.w_autoencoder.load_models`` /
``train_stage``, ``evaluate_counterfactuals.run_suites``) inside one
:class:`~pccf_torch.experiment.Experiment` named by ``--tag``.

The JAX tool's two deliberate departures from the published configuration,
both recorded in the output: the epochs are scaled (45 / 200 / 300 against
45 / 1000 / 500) and the stage-2 KLD weights default to 3.0 / 16.0 (the
published 0.1 / 4.0 are calibrated to ShapeNet's reconstruction energy; on
the surrogate both paid latent channels must cost more than the free
conditioning route, or the class bypasses it and the counterfactual steer
dies: ``BASELINE.md``'s round-5 section).  The codebook hook and stage 2's
KLD anneal run as in a real training; early stopping is off and the
checkpoints are written at the end.

The record holds the JAX tool's keys, read from the stages' return values:
``config`` (with ``objective_deviates_from_reference``), each stage's
``wall_s``, the VQ-VAE's final test Chamfer and EMD, stage 2's final loss
and the last epoch's ``final_klds`` (KLD1, KLD2, MSE, Quantisation
Accuracy), the suites, ``original_metrics`` (``ClassificationOriginal``),
``counterfeit_overall`` and ``misclassified_overall`` (the merged states);
and the classifier's confusion matrix.  Checkpoints and the trackers' CSVs
go under ``$ROOT_EXP_DIR`` (default ``experiments/<tag>/``, which git
ignores), the record to ``--out`` (relative to the repository's root).

    python -m pccf_torch.tools.quality_run [--epochs-cls N] [--epochs-ae N] [--epochs-wae N]
        [--c-kld1 F] [--c-kld2 F] [--n-train N] [--n-test N] [--variability F] [--tag TAG]
        [--smoke] [--cpu] [--eval-only | --stage2-only] [--clone-from TAG] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import time

from pccf_torch.tools import REPO, SMOKE_MODEL, SMOKE_W_MODEL, SURROGATE, device_of

SMOKE = (
    *SMOKE_MODEL, *SMOKE_W_MODEL,
    'classifier.train.batch_size=4',
    'autoencoder.objective.recon_loss=Chamfer',
    'autoencoder.train.batch_size=4',
    'autoencoder.diagnose_every=2',
    'w_autoencoder.train.batch_size=4',
)
PUBLISHED_C_KLD = (0.1, 4.0)  # configs/experiment w_autoencoder objective (vae_objective.yaml)
FINAL_KLDS = ('KLD1', 'KLD2', 'MSE', 'Quantisation Accuracy')
MERGED = {'OverallCounterfeit': 'counterfeit_overall', 'OverallMisclassifiedCounterfeit': 'misclassified_overall'}
# the record's keys, as paths of nested keys: the JAX tool's (it also writes
# misclassified_overall where some test cloud is misclassified, as this does)
RECORD_KEYS = (
    ('tag',), ('exp_dir',),
    *(('config', k) for k in ('n_classes', 'variability', 'n_train', 'n_test', 'points', 'epochs', 'c_kld',
                              'batch_sizes', 'objective_deviates_from_reference')),
    *(('stages', s, 'wall_s') for s in ('classifier', 'autoencoder', 'w_autoencoder', 'evaluate')),
    ('stages', 'autoencoder', 'final_test_chamfer'), ('stages', 'autoencoder', 'final_test_emd'),
    ('stages', 'w_autoencoder', 'final_loss'),
    *(('stages', 'w_autoencoder', 'final_klds', k) for k in FINAL_KLDS),
    *(('stages', 'evaluate', k) for k in ('original_metrics', 'suites', 'counterfeit_overall')),
)


def missing_keys(record: dict) -> list[tuple[str, ...]]:
    """The paths of :data:`RECORD_KEYS` that ``record`` lacks."""
    def has(tree, path):
        return not path or (isinstance(tree, dict) and path[0] in tree and has(tree[path[0]], path[1:]))
    return [path for path in RECORD_KEYS if not has(record, path)]


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs-cls', type=int, default=45)
    ap.add_argument('--epochs-ae', type=int, default=200)
    ap.add_argument('--epochs-wae', type=int, default=300)
    ap.add_argument('--c-kld1', type=float, default=3.0)
    ap.add_argument('--c-kld2', type=float, default=16.0)
    ap.add_argument('--n-train', type=int, default=512)
    ap.add_argument('--n-test', type=int, default=128)
    ap.add_argument('--variability', type=float, default=0.85)
    ap.add_argument('--tag', default='quality_torch')
    ap.add_argument('--smoke', action='store_true', help='tiny widths: the record\'s plumbing end to end')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU instead of the card')
    ap.add_argument('--eval-only', action='store_true',
                    help='skip training: run the suites on the tag\'s checkpoints')
    ap.add_argument('--stage2-only', action='store_true',
                    help='keep the tag\'s classifier and VQ-VAE checkpoints, train the inner CVAE again, evaluate')
    ap.add_argument('--clone-from', default=None, metavar='TAG',
                    help='copy TAG\'s experiment directory to this run\'s tag first (keeps TAG untouched)')
    ap.add_argument('--out', default='QUALITY_torch.json', help='the record\'s file, relative to the repository')
    return ap.parse_args(argv)


def overrides(args: argparse.Namespace) -> list[str]:
    """The experiment tree's overrides of the run (the JAX tool's list)."""
    out = [
        *SURROGATE,
        f'data.dataset.settings.n_train={args.n_train}',
        f'data.dataset.settings.n_test={args.n_test}',
        f'data.dataset.settings.variability={args.variability}',
        f'classifier.train.n_epochs={args.epochs_cls}',
        f'autoencoder.train.n_epochs={args.epochs_ae}',
        f'w_autoencoder.train.n_epochs={args.epochs_wae}',
        f'w_autoencoder.objective.c_kld1={args.c_kld1}',
        f'w_autoencoder.objective.c_kld2={args.c_kld2}',
        # the full schedule on the record, checkpoints at the end only
        'classifier.train.early_stopping.active=false',
        'autoencoder.train.early_stopping.active=false',
        'w_autoencoder.train.early_stopping.active=false',
        'user.checkpoint_every=0',
        'user.trackers.tensorboard=false',
        'user.trackers.csv=true',
        'user.seed=0',
    ]
    return out + list(SMOKE) if args.smoke else out


def clone(src_tag: str, tag: str, dst: pathlib.Path) -> None:
    """``experiments/<src_tag>`` copied to ``dst``, its runs renamed to ``tag``
    so that the experiment of this run resumes from them."""
    if dst.exists():
        return
    shutil.copytree(REPO / 'experiments' / src_tag, dst)
    for version in dst.iterdir():
        nested = version / src_tag
        if nested.is_dir() and not (version / tag).exists():
            nested.rename(version / tag)


def record_suites(record: dict, suites: dict[str, dict[str, float]]) -> None:
    """The suites' metrics into the evaluate stage's record: each suite, the
    original classification again as ``original_metrics``, the merged states
    under the JAX tool's names."""
    ev = record['stages']['evaluate']
    ev['original_metrics'] = dict(suites['ClassificationOriginal'])
    ev['suites'] = {name: dict(m) for name, m in suites.items() if name not in MERGED}
    for name, key in MERGED.items():
        if name in suites:
            ev[key] = dict(suites[name])


def main(argv: list[str] | None = None) -> dict:
    args = parse(argv)
    if args.eval_only and args.stage2_only:
        raise SystemExit('--eval-only and --stage2-only exclude each other')
    device = device_of(args.cpu)
    os.environ.setdefault('ROOT_EXP_DIR', str(REPO / 'experiments' / args.tag))
    os.environ.setdefault('DATASET_DIR', str(REPO / 'datasets'))
    if args.clone_from:
        clone(args.clone_from, args.tag, pathlib.Path(os.environ['ROOT_EXP_DIR']))

    from pccf_torch import cli, evaluate_counterfactuals
    from pccf_torch.data.dataset import get_dataset
    from pccf_torch.data.protocols import Partitions, Singleton
    from pccf_torch.experiment import Experiment
    from pccf_torch.train import autoencoder, classifier, w_autoencoder
    from pccf_torch.train.checkpoint import Checkpoint
    from pccf_torch.train.trackers import get_trackers

    Singleton.reset_all()
    cfg, tree = cli.get_config(overrides(args))
    exp = Experiment(cfg, tree, name=args.tag)
    for tracker in get_trackers(cfg):
        exp.subscribe(tracker)
    record: dict = {
        'tag': args.tag,
        'device': str(device),
        'config': {
            'n_classes': cfg.data.n_classes,
            'variability': args.variability,
            'n_train': args.n_train,
            'n_test': args.n_test,
            'points': cfg.data.n_input_points,
            'epochs': [args.epochs_cls, args.epochs_ae, args.epochs_wae],
            'c_kld': [args.c_kld1, args.c_kld2],
            'batch_sizes': [cfg.classifier.train.batch_size, cfg.autoencoder.train.batch_size,
                            cfg.w_autoencoder.train.batch_size],
            # the published weights are 0.1 / 4.0: a run that departs from them says so
            'objective_deviates_from_reference': (args.c_kld1, args.c_kld2) != PUBLISHED_C_KLD,
        },
        'stages': {},
    }

    def stage(name: str, fn):
        t0 = time.time()
        out = fn()
        seconds = time.time() - t0
        record['stages'][name] = {'wall_s': round(seconds, 1)}
        print(f'== stage {name} done in {seconds:.0f}s ==', flush=True)
        return out

    with exp.create_run():
        if not (args.eval_only or args.stage2_only):
            cls_out = stage('classifier', lambda: classifier.stage(cfg, device))
            record['stages']['classifier']['confusion_matrix'] = cls_out['confusion_matrix'].tolist()
            ae_out = stage('autoencoder', lambda: autoencoder.stage(cfg, device))
            ae_rec = record['stages']['autoencoder']
            ae_rec['final_test_chamfer'] = float(ae_out['test']['Chamfer'])
            if 'EMD' in ae_out['test']:
                ae_rec['final_test_emd'] = float(ae_out['test']['EMD'])
        judge, vqvae = w_autoencoder.load_models(cfg, device)
        if not args.eval_only:
            w_out = stage('w_autoencoder', lambda: w_autoencoder.train_stage(cfg, judge, vqvae, device))
            w_rec = record['stages']['w_autoencoder']
            w_rec['final_loss'] = float(w_out['loss'])
            last = w_out['trainer'].metrics_log[-1] if w_out['trainer'].metrics_log else {}
            w_rec['final_klds'] = {k: float(last[k]) for k in FINAL_KLDS if k in last}
            Checkpoint(cfg.autoencoder.name).save(vqvae, vqvae.epoch)  # the merged VQ-VAE, as the entry point
        dataset = get_dataset(cfg, Partitions.test if cfg.final else Partitions.val, device)
        suites = stage('evaluate', lambda: evaluate_counterfactuals.run_suites(cfg, judge, vqvae.eval(), dataset))
        record_suites(record, suites)

    record['exp_dir'] = os.environ['ROOT_EXP_DIR']
    out_path = REPO / args.out
    out_path.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    print(f'wrote {out_path}')
    return record


if __name__ == '__main__':
    main()

"""BatchNorm semantics A/B: statistics over the global batch against the
reference's per-replica statistics (``tools/bn_ab.py``).

The reference trains under DDP without SyncBatchNorm, so its BatchNorm
statistics are a replica's; the port, like the JAX package, takes them over
the global batch unless ``PCCF_BN_GROUPS=G`` splits every batch into G
groups (:func:`pccf_torch.nn.layers.bn_groups`).  Each arm trains the
classifier and the VQ-VAE on the 4-class surrogate (``--epochs`` each, the
same seed and data, ``final=True``) with one G and records the final test
metrics: the classifier's test accuracy and misclassified count, the
VQ-VAE's final test Chamfer and EMD, and each stage's seconds, read from
the stages' return values.  An arm runs in a subprocess of its own (the
group count is read from the environment, the experiment's singletons are
a process's), its experiment under ``<root>/bn_ab_g<G>``; on the card unless
``--cpu``.

    python -m pccf_torch.tools.bn_ab [--epochs 30] [--groups 1 8] [--n-train N] [--n-test N]
        [--cpu] [--smoke] [--root DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

from pccf_torch.tools import REPO, SMOKE_MODEL, SURROGATE, device_of

SMOKE = (*SMOKE_MODEL, 'classifier.train.batch_size=8', 'autoencoder.objective.recon_loss=Chamfer',
         'autoencoder.train.batch_size=8')
ARM_LINE = 'BN_AB_ARM '


def overrides(args: argparse.Namespace) -> list[str]:
    out = [
        *SURROGATE,
        f'data.dataset.settings.n_train={args.n_train}',
        f'data.dataset.settings.n_test={args.n_test}',
        'data.dataset.settings.variability=0.85',
        f'classifier.train.n_epochs={args.epochs}',
        f'autoencoder.train.n_epochs={args.epochs}',
        'classifier.train.early_stopping.active=false',
        'autoencoder.train.early_stopping.active=false',
        'user.checkpoint_every=0',
        'user.trackers.tensorboard=false',
        'user.trackers.csv=false',
        'user.seed=0',
        'final=True',
    ]
    return out + list(SMOKE) if args.smoke else out


def run_arm(groups: int, args: argparse.Namespace) -> dict:
    """One arm in this process: the classifier, then the VQ-VAE, at ``groups``."""
    os.environ['PCCF_BN_GROUPS'] = str(groups)
    os.environ['ROOT_EXP_DIR'] = str(pathlib.Path(args.root) / f'bn_ab_g{groups}')
    os.environ.setdefault('DATASET_DIR', str(REPO / 'datasets'))
    device = device_of(args.cpu)

    from pccf_torch import cli
    from pccf_torch.data.protocols import Singleton
    from pccf_torch.experiment import Experiment
    from pccf_torch.train import autoencoder, classifier

    Singleton.reset_all()
    cfg, tree = cli.get_config(overrides(args))
    rec: dict = {'groups': groups}
    with Experiment(cfg, tree, name=f'bn_ab_g{groups}').create_run():
        t0 = time.time()
        cls_out = classifier.stage(cfg, device)
        rec['classifier_wall_s'] = round(time.time() - t0, 1)
        rec['classifier_test_accuracy'] = float(cls_out['test']['Accuracy'])
        rec['classifier_misclassified'] = len(cls_out['misclassified'])
        t0 = time.time()
        ae_out = autoencoder.stage(cfg, device)
        rec['autoencoder_wall_s'] = round(time.time() - t0, 1)
        rec['final_test_chamfer'] = float(ae_out['test']['Chamfer'])
        if 'EMD' in ae_out['test']:
            rec['final_test_emd'] = float(ae_out['test']['EMD'])
    return rec


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs', type=int, default=30)
    ap.add_argument('--n-train', type=int, default=512)
    ap.add_argument('--n-test', type=int, default=128)
    ap.add_argument('--groups', type=int, nargs='+', default=[1, 8])
    ap.add_argument('--cpu', action='store_true', help='run on the CPU instead of the card')
    ap.add_argument('--smoke', action='store_true', help='tiny widths: the arms\' plumbing end to end')
    ap.add_argument('--root', default=str(REPO / 'experiments'), help='where the arms\' experiments go')
    ap.add_argument('--out', default=None, help='the results\' file (default: <root>/bn_ab_results.json)')
    ap.add_argument('--arm', type=int, default=None, help=argparse.SUPPRESS)  # one arm, in this process
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse(argv)
    if args.arm is not None:
        rec = run_arm(args.arm, args)
        print(ARM_LINE + json.dumps(rec), flush=True)
        return rec
    results = {}
    flags = ['--epochs', str(args.epochs), '--n-train', str(args.n_train), '--n-test', str(args.n_test),
             '--root', args.root, *(['--cpu'] if args.cpu else []), *(['--smoke'] if args.smoke else [])]
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(filter(None, [str(REPO), os.environ.get('PYTHONPATH')]))}
    for g in args.groups:
        print(f'=== arm G={g} ===', flush=True)
        proc = subprocess.run([sys.executable, '-m', 'pccf_torch.tools.bn_ab', '--arm', str(g), *flags],
                              capture_output=True, text=True, cwd=REPO, env=env)
        sys.stderr.write(proc.stderr[-2000:])
        m = re.search('^' + ARM_LINE + '(.*)$', proc.stdout, re.M)
        results[f'g{g}'] = json.loads(m.group(1)) if m else {'error': proc.stdout[-1500:] + proc.stderr[-500:]}
        print(json.dumps(results[f'g{g}'], indent=1), flush=True)
    out = pathlib.Path(args.out) if args.out else pathlib.Path(args.root) / 'bn_ab_results.json'
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f'wrote {out}')
    return results


if __name__ == '__main__':
    main()

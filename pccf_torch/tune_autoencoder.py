"""Hyper-parameter tuning of the VQ-VAE (``tune_autoencoder.py``).

A study of the tuning tree ``configs/tuning/autoencoder`` (the space that
``tune=<space>`` selects: ``learn``, ``encoder``, ``decoder`` or
``embedding``) with :mod:`pccf_torch.tuning`'s sampler, median pruner and
sqlite storage.  Each trial composes the experiment tree with the study's
``overrides`` and the trial's suggestions, and runs stage 1
(:func:`pccf_torch.train.autoencoder.stage`) in an experiment named
``Trial`` that records nothing, its reconstruction objective reported to the
trial after every epoch.  A pruned trial's value is imputed from the
completed ones, as is a diverged one's (``ConvergenceError``).  A trial runs
on the card unless its configuration asks for the CPU (``user.cpu=true``).

    python -m pccf_torch.tune_autoencoder tune=learn tune.n_trials=3 \\
        'overrides=["data/dataset=synthetic","autoencoder.train.n_epochs=2"]'

The study's database and plots go under ``db_location``
(``optimization_db`` by default).
"""

from __future__ import annotations

import pathlib
import sys
from typing import Callable

from pccf_torch import cli, tuning
from pccf_torch.config import paths
from pccf_torch.experiment import Experiment
from pccf_torch.train.autoencoder import stage
from pccf_torch.train.runners import ConvergenceError

TUNING_DIR = pathlib.Path(__file__).resolve().parents[1] / 'configs' / 'tuning' / 'autoencoder'


def set_objective(tune_cfg: dict) -> Callable[[tuning.Trial], float]:
    def objective(trial: tuning.Trial) -> float:
        overrides = tuning.suggest_overrides(tune_cfg, trial)
        cfg, _ = cli.get_config(overrides)
        # the trials' checkpoints go to 'Trial', not to the experiment's own
        exp = Experiment(cfg, name='Trial', par_dir=paths().version_dir, tags=overrides)
        with exp.create_run(record=False):
            try:
                stage(cfg, cli.device(cfg), trial=trial)
            except tuning.TrialPruned:
                return tuning.impute_pruned_trial(trial)
            except ConvergenceError:
                return tuning.impute_failed_trial(trial)
        return tuning.get_final_value(trial)

    return objective


def main(argv: list[str] | None = None) -> tuning.Study:
    return tuning.run_study(TUNING_DIR, set_objective, sys.argv[1:] if argv is None else argv)


if __name__ == '__main__':
    main()

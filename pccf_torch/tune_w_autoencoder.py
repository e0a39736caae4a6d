"""Hyper-parameter tuning of the inner CVAE (``tune_w_autoencoder.py``).

A study of the tuning tree ``configs/tuning/w_autoencoder`` (``tune=learn``,
``w_encoder``, ``w_decoder`` or ``conditional_w_encoder``).  The frozen
outer models, the classifier and the VQ-VAE without its inner CVAE, are
loaded once from the experiment the study's ``overrides`` compose, and
shared across trials: each trial builds a VQ-VAE of its own configuration,
takes every entry of the trained one's ``state_dict`` outside the inner
CVAE (parameters and BatchNorm buffers) and keeps its fresh inner CVAE,
then runs stage 2 (:func:`pccf_torch.train.w_autoencoder.train_stage`) in
an experiment named ``Trial`` that records nothing, its loss reported to
the trial after every epoch.  Pruned and diverged trials are imputed as in
:mod:`pccf_torch.tune_autoencoder`.  The models run on the card unless the
configuration asks for the CPU (``user.cpu=true``).

    python -m pccf_torch.tune_w_autoencoder tune=learn tune.n_trials=2 \\
        'overrides=["data/dataset=synthetic","w_autoencoder.train.n_epochs=2"]'
"""

from __future__ import annotations

import pathlib
import sys
from typing import Callable

import torch

from pccf_torch import cli, tuning
from pccf_torch.config import paths
from pccf_torch.experiment import Experiment
from pccf_torch.models.autoencoders import VQVAE
from pccf_torch.train import autoencoder
from pccf_torch.train.runners import FROZEN, ConvergenceError
from pccf_torch.train.w_autoencoder import load_models, train_stage

TUNING_DIR = pathlib.Path(__file__).resolve().parents[1] / 'configs' / 'tuning' / 'w_autoencoder'


def split_frozen_outer(vqvae: VQVAE) -> dict[str, torch.Tensor]:
    """Every entry of the trained VQ-VAE's ``state_dict`` outside the inner
    CVAE, parameters and BatchNorm buffers alike (``tune_w_autoencoder.py:24-37``):
    the frozen encoder runs in eval inside every trial, so its running
    statistics go with its weights."""
    return {k: v.detach().clone() for k, v in vqvae.state_dict().items() if k.split('.')[0] != FROZEN}


def graft_frozen_outer(new_vqvae: VQVAE, frozen_outer: dict[str, torch.Tensor]) -> None:
    """The frozen outer entries onto a freshly built trial model, whose inner
    CVAE stays as it was built (``tune_w_autoencoder.py:40-49``)."""
    new_vqvae.load_state_dict({**new_vqvae.state_dict(), **frozen_outer})


def set_objective(tune_cfg: dict) -> Callable[[tuning.Trial], float]:
    # the frozen models are composed with the study's fixed overrides, which
    # every trial's configuration starts from, so their shapes match
    main_cfg, _ = cli.get_config(list(tune_cfg.get('overrides', [])))
    device = cli.device(main_cfg)
    with Experiment(main_cfg).create_run(record=False):
        classifier, vqvae = load_models(main_cfg, device)
    frozen_outer = split_frozen_outer(vqvae)

    def objective(trial: tuning.Trial) -> float:
        overrides = tuning.suggest_overrides(tune_cfg, trial)
        cfg, _ = cli.get_config(overrides)
        exp = Experiment(cfg, name='Trial', par_dir=paths().version_dir, tags=overrides)
        with exp.create_run(record=False):
            new_vqvae = autoencoder.build(cfg, cfg.user.seed or 0)
            graft_frozen_outer(new_vqvae, frozen_outer)
            new_vqvae = new_vqvae.to(device).eval()
            try:
                train_stage(cfg, classifier, new_vqvae, device, trial=trial)
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

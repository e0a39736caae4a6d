"""The command line of the port's entry points (``pccf/config/cli.py``).

Every entry point takes the JAX scripts' arguments: ``key=value``,
``+key=value``, ``~key`` and ``group/sub=option`` overrides of the
experiment tree, and the ``--config-dir`` and ``--config-name`` flags.
:func:`get_config` composes the tree (:mod:`pccf_torch.compose`), reads it
into a :class:`~pccf_torch.config.SliceConfig` and seeds numpy's global
generator with ``user.seed`` where it is set, as ``get_config_all`` does;
:func:`parse_args` folds the overrides into the experiment's name and tags
(``hydra_main``, ``cli.py:80-123``).  :func:`device` is the card unless
``user.cpu`` asks for the CPU; without a card it raises.

    cfg, tree = parse_args(['data/dataset=synthetic', 'user.cpu=true'])

:func:`run` is what every ``main`` does: parse the arguments, pick the
device, subscribe the trackers to the :class:`~pccf_torch.experiment.
Experiment` and run the stage inside it.  For the training stages, with
``user.n_subprocesses`` set, it hands the stage to
:class:`~pccf_torch.dist.DistributedWorker`, as the JAX scripts do
(``train_autoencoder.py:137-140``): every rank runs the stage inside the
experiment, rank 0 with its directory and trackers.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import pathlib
import sys
from typing import Any, Callable

import numpy as np
import torch

from pccf_torch.compose import compose
from pccf_torch.config import SliceConfig
from pccf_torch.experiment import Experiment

DEFAULT_CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / 'configs' / 'experiment'


def get_config(overrides: list[str] | None = None, config_dir: str | pathlib.Path = DEFAULT_CONFIG_DIR,
               config_name: str = 'defaults') -> tuple[SliceConfig, dict]:
    """The configuration of ``overrides`` and the composed tree it was read from."""
    tree = compose(config_dir, config_name, overrides=overrides)
    cfg = SliceConfig.from_tree(tree)
    if cfg.user.seed is not None:
        np.random.seed(cfg.user.seed)
    return cfg, tree


def update_exp_name(cfg_name: str, overrides: list[str]) -> tuple[str, list[str]]:
    """The overrides folded into the experiment name and tags
    (``pccf/config/experiment.py`` ``update_exp_name``): the first four
    ``key=value`` overrides as ``key-value`` suffixes, one path component."""
    tags = [ov for ov in overrides if '=' in ov]
    suffix = '_'.join(t.split('=')[0].split('.')[-1].split('/')[-1] + '-' + t.split('=', 1)[1]
                      for t in tags[:4]).replace('/', '-')
    name = f'{cfg_name}_{suffix}' if suffix else cfg_name
    return name[:255], tags


def split_argv(argv: list[str]) -> tuple[pathlib.Path | str, str, list[str]]:
    """``(config_dir, config_name, overrides)`` of the arguments."""
    config_dir: pathlib.Path | str = DEFAULT_CONFIG_DIR
    config_name = 'defaults'
    overrides: list[str] = []
    it = iter(argv)
    for arg in it:
        if arg in ('--config-dir', '--config-name') or arg.startswith(('--config-dir=', '--config-name=')):
            if '=' in arg:
                flag, value = arg.split('=', 1)
            else:
                flag, value = arg, next(it, None)
                if value is None:
                    raise SystemExit(f'{flag} requires a value')
            if flag == '--config-dir':
                config_dir = value
            else:
                config_name = value
        elif arg.startswith('--'):
            raise SystemExit(f'unknown flag {arg!r} (supported: --config-dir, --config-name)')
        else:
            overrides.append(arg)
    return config_dir, config_name, overrides


def parse_args(argv: list[str]) -> tuple[SliceConfig, dict]:
    """The configuration the arguments give, with the overrides folded into
    ``variation`` and ``tags``, and its composed tree with the same two
    fields."""
    config_dir, config_name, overrides = split_argv(argv)
    cfg, tree = get_config(overrides, config_dir, config_name)
    name, tags = update_exp_name(cfg.variation, overrides)
    cfg = dataclasses.replace(cfg, variation=name, tags=(*cfg.tags, *tags))
    return cfg, {**tree, 'variation': cfg.variation, 'tags': list(cfg.tags)}


def device(cfg: SliceConfig) -> torch.device:
    """The CPU where ``user.cpu`` asks for it, else the card; without a card
    this raises, and the run does not go on on the CPU."""
    if cfg.user.cpu:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the entry points run on the card unless user.cpu=true')
    return torch.device('cuda')


def run(argv: list[str] | None, stage: Callable[[SliceConfig, torch.device], Any],
        data_parallel: bool = False) -> Any:
    """``stage(cfg, device)`` inside the experiment the arguments (by default
    ``sys.argv[1:]``) configure.  Where ``data_parallel`` and
    ``user.n_subprocesses`` is set, each of that many ranks runs it
    (:func:`run_rank`) and this returns None; ``stage`` is then a
    module-level function, which the ranks import."""
    cfg, tree = parse_args(sys.argv[1:] if argv is None else list(argv))
    if data_parallel and cfg.user.n_subprocesses:
        from pccf_torch.dist import DistributedWorker

        module = stage.__module__
        if module == '__main__':  # python -m <entry point>: the ranks import it by its name
            module = sys.modules['__main__'].__spec__.name
        DistributedWorker(functools.partial(run_rank, module, stage.__qualname__, tree),
                          cfg.user.n_subprocesses).spawn(cfg)
        return None
    return _run_stage(cfg, tree, stage, device(cfg))


def run_rank(module: str, name: str, tree: dict, cfg: SliceConfig) -> Any:
    """One data-parallel rank's run of the stage ``module.name``: on the
    CPU under ``user.cpu``, else on its card, ``cuda:rank``."""
    from pccf_torch.dist import mesh

    stage = getattr(importlib.import_module(module), name)
    dev = device(cfg)
    if dev.type == 'cuda':
        dev = torch.device('cuda', mesh.rank())
    return _run_stage(cfg, tree, stage, dev)


def _run_stage(cfg: SliceConfig, tree: dict, stage: Callable[[SliceConfig, torch.device], Any],
               dev: torch.device) -> Any:
    from pccf_torch.dist import mesh
    from pccf_torch.train.trackers import get_trackers

    exp = Experiment(cfg, tree)
    main = mesh.is_main_process()
    for tracker in get_trackers(cfg) if main else ():
        exp.subscribe(tracker)
    with exp.create_run(record=main):
        return stage(cfg, dev)

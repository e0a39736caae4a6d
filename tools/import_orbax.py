"""Import a run of the JAX package into the port's checkpoint layout.

    python tools/import_orbax.py SRC_EXP_DIR [overrides ...] [--dst DST_EXP_DIR] [--epoch N]

``SRC_EXP_DIR`` is a JAX experiment directory (``<version_dir>/<name>``).
The overrides are the experiment tree's, as the entry points take them: they
compose the configuration whose models the checkpoints hold (the port's
``pccf_torch.cli``), and name the port's experiment directory, which ``--dst``
replaces.  For each of the configuration's three models found under
``SRC_EXP_DIR/models/<name>/checkpoints`` (the classifier, the stage-1
VQ-VAE, and stage 2's ``WAETrainModule`` shell), every ``epoch_N`` (or the
one ``--epoch`` names) is restored with orbax (``pccf/train/model.py:59-87``),
its ``variables`` converted by :func:`pccf_torch.convert.flax_to_state_dict`,
loaded strictly into the port's model (so a missing or extra tensor raises)
and written as the port's ``epoch_N`` (``pccf_torch/train/checkpoint.py``).

Where the trainer's sidecar ``epoch_N_opt`` exists (``runners.py:441-454``),
the port's sidecar is written too:

- the optax moments and counts onto the port optimiser's state by optax's
  rules (AdamW and Adam: ``mu``, ``nu`` and the count as ``exp_avg``,
  ``exp_avg_sq`` and ``step``; SGD: the momentum trace; RMSprop: ``nu``,
  ``mu`` where centred, the momentum trace), whether the state was raveled
  into one vector by ``optax.flatten`` (``PCCF_FLAT_OPT``, the default,
  ``runners.py:233-243``: unravelled in ``jax.tree`` leaf order, dictionary
  keys sorted) or kept per leaf, also under stage 1's ``multi_transform``
  (``runners.py:246-256``, the frozen ``w_autoencoder`` masked out);
- the step;
- the gradient operation's state (the history clippers' running statistics
  and their count), from the first transform of the chain.

The JAX run's PRNG key has no counterpart in the port's ``torch.Generator``:
an imported resume is exact in weights, moments and step, not in sampling
noise.  The sidecar carries ``generator_seed`` (``user.seed``, else 0)
instead of a generator state, and a port trainer resuming from it seeds its
generator with that seed on whatever device it runs.

orbax imports JAX, so this tool runs where the JAX package is installed and
stays outside ``pccf_torch``'s import path; what it writes needs only torch.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import re
import sys
from typing import Any

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pccf_torch import cli  # noqa: E402
from pccf_torch.config import SliceConfig, paths  # noqa: E402
from pccf_torch.convert import flax_to_state_dict  # noqa: E402
from pccf_torch.experiment import Experiment  # noqa: E402
from pccf_torch.train.checkpoint import Checkpoint  # noqa: E402
from pccf_torch.train.runners import FROZEN, Trainer  # noqa: E402


def restore(path: pathlib.Path) -> dict:
    """An orbax checkpoint as nested dicts and lists of numpy arrays (named
    tuples as dicts of their fields, empty states as None), with no template."""
    import orbax.checkpoint as ocp

    logging.getLogger('absl').setLevel(logging.ERROR)  # restoring without a target tree warns
    return ocp.StandardCheckpointer().restore(path.resolve())


# ------------------------------------------------------------------ models


def build(kind: str, cfg: SliceConfig) -> tuple[torch.nn.Module, Any, Any, str]:
    """``(port model, its trainer's configuration, its objective, the prefix
    of its flax names)`` of a model kind."""
    if kind == 'classifier':
        from pccf_torch.nn import ClassifierTrainModule, build_classifier
        from pccf_torch.train import get_classification_loss

        return (ClassifierTrainModule(build_classifier(cfg)), cfg.classifier.train, get_classification_loss(),
                'classifier.')
    if kind == 'autoencoder':
        from pccf_torch.models import build_vqvae
        from pccf_torch.train import get_autoencoder_loss

        return build_vqvae(cfg), cfg.autoencoder.train, get_autoencoder_loss(cfg), ''
    from pccf_torch.models import WAETrainModule, build_w_autoencoder
    from pccf_torch.train import get_w_autoencoder_loss

    wcfg = cfg.w_autoencoder.train
    return (WAETrainModule(build_w_autoencoder(cfg), cfg.autoencoder.book_size), wcfg,
            get_w_autoencoder_loss(wcfg, cfg.w_autoencoder.n_pseudo_inputs), '')


def _prune(tree: Any) -> Any:
    """``tree`` without its None leaves (masked or empty), empty dicts dropped."""
    if isinstance(tree, dict):
        out = {k: _prune(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return tree


def _leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """``(path, array)`` in ``jax.tree`` leaf order: dictionary keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v, (*prefix, k)) if isinstance(v, dict) else [((*prefix, k), np.asarray(v))])
    return out


def _unflatten(pairs: list[tuple[tuple, np.ndarray]]) -> dict:
    out: dict = {}
    for path, a in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def as_tree(state: Any, params: dict) -> dict:
    """A moment of the optimiser as a tree shaped like ``params``: as stored
    where it is a tree, unravelled where ``optax.flatten`` made it one vector
    (``jax.flatten_util.ravel_pytree``'s order)."""
    if isinstance(state, dict):
        return _prune(state)
    flat, pairs, start = np.asarray(state).reshape(-1), [], 0
    for path, p in _leaves(params):
        pairs.append((path, flat[start: start + p.size].reshape(p.shape)))
        start += p.size
    if start != flat.size:
        raise ValueError(f'a flat optimiser state of {flat.size} values does not ravel {start} parameters')
    return _unflatten(pairs)


def by_name(tree: dict, prefix: str) -> dict[str, torch.Tensor]:
    """A ``params``-shaped tree under the port's parameter names."""
    return {prefix + k: v for k, v in flax_to_state_dict({'params': tree}).items()}


def scalars_by_name(tree: dict, params: dict, prefix: str) -> dict[str, float]:
    """A tree of one scalar a parameter (the per-parameter clipper's) under
    the port's names: each scalar broadcast to its parameter's shape, so the
    conversion's renames apply, and read back."""
    full = _unflatten([(path, np.full(np.shape(_get(params, path)), float(np.asarray(v)), np.float32))
                       for path, v in _leaves(_prune(tree))])
    return {k: float(v.reshape(-1)[0]) for k, v in by_name(full, prefix).items()}


def _get(tree: dict, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------- optimiser state


def _states(node: Any) -> list[dict]:
    """The optax states in ``node`` that hold a field the importer reads
    (restored as dicts of their fields), depth first: in chain order."""
    if isinstance(node, list):
        return [s for v in node for s in _states(v)]
    if isinstance(node, dict):
        if set(node) & {'count', 'mu', 'nu', 'trace', 'mean', 'var', 'seen'}:
            return [node]
        return [s for v in node.values() for s in _states(v)]
    return []


def split_chain(opt_state: Any) -> tuple[Any, Any]:
    """``(the gradient operation's state, the optimiser's)`` of a trainer's
    ``optax.chain(grad_op, opt)``, under stage 1's ``multi_transform`` the
    trained partition's."""
    if isinstance(opt_state, dict) and 'inner_states' in opt_state:
        opt_state = opt_state['inner_states']['train']['inner_state']
    if not isinstance(opt_state, list) or len(opt_state) != 2:
        raise ValueError(f'not an optax.chain(grad_op, optimizer) state: {type(opt_state).__name__}')
    return opt_state[0], opt_state[1]


def optimizer_state(trainer: Trainer, names: list[str], opt: Any, params: dict, prefix: str) -> dict:
    """The port optimiser's ``state_dict`` for the optax state ``opt``."""
    fields = _states(opt)
    moments: dict[str, dict[str, torch.Tensor]] = {}
    count = None
    for f in fields:
        for key in ('mu', 'nu', 'trace'):
            if key in f and f[key] is not None:
                moments[key] = by_name(as_tree(f[key], params), prefix)
        if 'count' in f and count is None:
            count = int(np.asarray(f['count']))
    kind = trainer.optimizer.__class__.__name__
    state = {}
    for i, name in enumerate(names):
        if kind in ('AdamW', 'Adam'):
            state[i] = {'step': torch.tensor(float(count)), 'exp_avg': moments['mu'][name],
                        'exp_avg_sq': moments['nu'][name]}
        elif kind == 'SGD':
            if 'trace' in moments:
                state[i] = {'momentum_buffer': moments['trace'][name]}
        elif kind == 'RMSprop':
            group = trainer.optimizer.param_groups[0]
            state[i] = {'count': int(trainer.step), 'nu': moments['nu'][name]}
            if group['centered']:
                state[i]['mu'] = moments['mu'][name]
            if group['momentum'] is not None:
                state[i]['trace'] = moments['trace'][name]
        else:
            raise ValueError(f'no import rule for the optimiser {kind}')
    return {'state': state, 'param_groups': trainer.optimizer.state_dict()['param_groups']}


def grad_op_state(trainer: Trainer, grad: Any, params: dict, prefix: str) -> dict:
    """The port gradient operation's ``state_dict`` for the chain's first state."""
    op = trainer.grad_op
    if not op.state_dict():  # a stateless operation
        return {}
    if not isinstance(grad, dict):
        raise ValueError(f'{type(op).__name__}: the JAX gradient operation kept no state')
    seen = int(np.asarray(grad['seen']))
    if isinstance(grad['mean'], dict):  # one statistic a parameter, in the port's order
        mean, var = (scalars_by_name(grad[k], params, prefix) for k in ('mean', 'var'))
        values = [torch.tensor([d[n] for n in op.names]) for d in (mean, var)]
    else:
        values = [torch.tensor([float(np.asarray(grad[k]))]) for k in ('mean', 'var')]
    return {'mean': values[0], 'var': values[1], 'seen': seen}


# ------------------------------------------------------------------ import


def import_model(kind: str, name: str, src: pathlib.Path, cfg: SliceConfig, epochs: list[int] | None = None
                 ) -> list[int]:
    """Write the port's checkpoints of the JAX model ``name`` found under
    ``src``, into the current experiment; returns the epochs written."""
    directory = src / 'models' / name / 'checkpoints'
    found = sorted(int(m.group(1)) for p in directory.iterdir() if (m := re.fullmatch(r'epoch_(\d+)', p.name)))
    done = []
    for epoch in epochs if epochs is not None else found:
        if epoch not in found:
            raise FileNotFoundError(f'no checkpoint epoch_{epoch} under {directory}')
        payload = restore(directory / f'epoch_{epoch}')
        variables = payload['variables']
        model, tcfg, objective, prefix = build(kind, cfg)
        model.load_state_dict({prefix + k: v for k, v in flax_to_state_dict(variables).items()}, strict=True)
        sidecar = directory / f'epoch_{epoch}_opt'
        if not sidecar.exists():
            Checkpoint(name).save(model, epoch)
        else:
            side = restore(sidecar)
            trainer = Trainer(model, objective, tcfg, 1, seed=cfg.user.seed or 0, name=name)
            names = [n for n, _ in model.named_parameters() if n.split('.')[0] != FROZEN]
            grad, opt = split_chain(side['opt_state'])
            params = {k: v for k, v in variables['params'].items() if k != FROZEN}
            trainer.step = int(side['step'])
            trainer.optimizer.load_state_dict(optimizer_state(trainer, names, opt, params, prefix))
            if trainer.grad_op is not None:
                trainer.grad_op.load_state_dict(grad_op_state(trainer, grad, params, prefix))
            trainer.epoch = epoch
            trainer.save_checkpoint(generator_seed=cfg.user.seed or 0)
        done.append(epoch)
    return done


def main(argv: list[str] | None = None) -> dict[str, list[int]]:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('src', type=pathlib.Path, help='the JAX experiment directory')
    ap.add_argument('--dst', type=pathlib.Path, default=None, help="the port's experiment directory")
    ap.add_argument('--epoch', type=int, default=None, help='one epoch (default: every epoch found)')
    args, overrides = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg, tree = cli.parse_args(overrides)
    dst = args.dst or paths().version_dir / cfg.name
    exp = Experiment(cfg, tree, name=dst.name, par_dir=dst.parent)
    written = {}
    with exp.create_run():
        for kind, name in (('classifier', cfg.classifier.name), ('autoencoder', cfg.autoencoder.name),
                           ('w_autoencoder', cfg.w_autoencoder.name)):
            if (args.src / 'models' / name / 'checkpoints').is_dir():
                written[name] = import_model(kind, name, args.src, cfg,
                                             None if args.epoch is None else [args.epoch])
                print(f'{name}: epochs {written[name]} -> {Checkpoint(name).directory}')
    return written


if __name__ == '__main__':
    main()

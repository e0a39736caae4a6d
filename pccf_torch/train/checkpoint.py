"""Checkpoints of a model (``pccf/train/model.py`` ``Checkpoint`` and
``runners.py:441-488``).

A model's checkpoints live in ``exp_dir/models/<name>/checkpoints`` of the
current :class:`~pccf_torch.experiment.Experiment`: ``epoch_N`` holds the
``state_dict`` and the epoch (``torch.save``), and a trainer adds the
``epoch_N_opt`` sidecar with what an exact resume needs: the optimiser's
state, the gradient operation's, the step and the trainer's generator.
:meth:`Checkpoint.load` takes -1 for the latest or an epoch, and raises
``FileNotFoundError`` as JAX's does for an empty directory or a missing epoch.
"""

from __future__ import annotations

import pathlib
import re

import torch

from pccf_torch.experiment import Experiment


class Checkpoint:
    def __init__(self, name: str) -> None:
        self.name = name

    @property
    def directory(self) -> pathlib.Path:
        return Experiment.current().exp_dir / 'models' / self.name / 'checkpoints'

    def epochs(self) -> list[int]:
        if not self.directory.exists():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := re.fullmatch(r'epoch_(\d+)', p.name)))

    def path(self, epoch: int) -> pathlib.Path:
        return self.directory / f'epoch_{epoch}'

    def sidecar(self, epoch: int) -> pathlib.Path:
        return self.directory / f'epoch_{epoch}_opt'

    def save(self, model: torch.nn.Module, epoch: int, state: dict | None = None) -> pathlib.Path:
        """Write ``model``'s ``state_dict`` (or ``state``, the one-device
        state of a sharded model) at ``epoch``."""
        path = self.path(epoch)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({'state_dict': model.state_dict() if state is None else state, 'epoch': epoch}, path)
        return path

    def resolve(self, checkpoint: int = -1) -> int:
        """The epoch that ``checkpoint`` names: -1 the latest, else itself."""
        epochs = self.epochs()
        if not epochs:
            raise FileNotFoundError(f'No checkpoints under {self.directory}')
        epoch = epochs[checkpoint] if checkpoint < 0 else checkpoint
        if epoch not in epochs:
            raise FileNotFoundError(f'Checkpoint epoch {epoch} not in {epochs}')
        return epoch

    def load(self, model: torch.nn.Module, checkpoint: int = -1, load=None) -> int:
        """Load the weights of ``checkpoint`` into ``model`` (through
        ``load(state_dict)`` where given: a sharded model takes its slices);
        returns its epoch."""
        epoch = self.resolve(checkpoint)
        payload = torch.load(self.path(epoch), map_location=next(iter(model.state_dict().values())).device,
                             weights_only=True)
        (load or model.load_state_dict)(payload['state_dict'])
        return int(payload['epoch'])

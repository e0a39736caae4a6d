"""The experiment's directory and the run context (``pccf/config/experiment.py``).

An :class:`Experiment` holds the configuration, the composed tree and the
trackers; its directory is ``<version_dir>/<name>`` (``exp_dir``), where
:meth:`Experiment.create_run` writes ``config.json`` (the composed tree),
starts the trackers and makes the experiment :meth:`Experiment.current`
until the run ends.  Checkpoints go under ``exp_dir/models/<model>/
checkpoints`` (:mod:`pccf_torch.train.checkpoint`).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
from typing import Any, Iterator

from pccf_torch.config import SliceConfig, paths


class Experiment:
    _current: 'Experiment | None' = None

    def __init__(self, config: SliceConfig, tree: dict | None = None, name: str | None = None,
                 par_dir: str | pathlib.Path | None = None, tags: list[str] | None = None) -> None:
        self.config = config
        self.tree = tree if tree is not None else {}
        self.exp_name = name or config.name
        self.par_dir = pathlib.Path(par_dir) if par_dir else paths().version_dir
        self.tags = list(tags if tags is not None else config.tags)
        self.trackers: list[Any] = []

    @classmethod
    def current(cls) -> 'Experiment':
        if cls._current is None:
            raise RuntimeError('No active Experiment.')
        return cls._current

    @property
    def exp_dir(self) -> pathlib.Path:
        return self.par_dir / self.exp_name

    def subscribe(self, tracker: Any) -> None:
        self.trackers.append(tracker)

    @contextlib.contextmanager
    def create_run(self, record: bool = True) -> Iterator['Experiment']:
        """Make this experiment current, write its directory and
        ``config.json`` where ``record``, start the trackers; stop them when
        the run ends.  The trainer picks the checkpoint a run resumes from."""
        prev = Experiment._current
        Experiment._current = self
        try:
            if record:
                self.exp_dir.mkdir(parents=True, exist_ok=True)
                self.dump_config()
            for tracker in self.trackers:
                tracker.start(self)
            yield self
        finally:
            for tracker in self.trackers:
                try:
                    tracker.stop()
                except Exception:
                    pass
            Experiment._current = prev

    def dump_config(self) -> None:
        (self.exp_dir / 'config.json').write_text(json.dumps(self.tree, default=str, indent=2))

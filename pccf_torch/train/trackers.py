"""Metric trackers (``pccf/train/trackers.py``): stdout, CSV, SQLite and the
composed config's copy.

A tracker has ``start(exp)``, ``log_metrics(model, source, epoch, metrics)``
and ``stop()``; :func:`dispatch_metrics` hands every row to the current
experiment's trackers (``runners.py:127-137``).  :func:`get_trackers` builds
the list the ``user.trackers`` flags ask for; the TensorBoard and wandb
trackers need ``tensorboardX`` and ``wandb``, and where the package is
missing they are skipped with a log line, as ``get_trackers`` does
(``trackers.py:223-246``).  While a run is on, ``TensorBoardTracker`` and
``WandbTracker`` are reachable through ``require_current`` /
``get_current``, which raise :class:`TrackerNotUsedError` when no such
tracker was started (``trackers.py:23-35``): the reconstruction hooks and
the classifier's figure write through them.
"""

from __future__ import annotations

import csv
import logging
import pathlib
import shutil
import sqlite3
from typing import Any

from pccf_torch.config import VERSION
from pccf_torch.dist import mesh
from pccf_torch.experiment import Experiment

logger = logging.getLogger('pccf_torch')


class TrackerNotUsedError(RuntimeError):
    """The tracker asked for is not subscribed to the current run."""


class _CurrentMixin:
    """The started instance of a tracker class, while its run is on."""

    _current: Any = None

    @classmethod
    def require_current(cls):
        if cls._current is None:
            raise TrackerNotUsedError(f'{cls.__name__} is not active')
        return cls._current

    @classmethod
    def get_current(cls):
        return cls.require_current()


class BuiltinLogger:
    """Metrics printed through ``logging``."""

    def start(self, exp) -> None:
        logging.basicConfig(level=logging.INFO, format='%(message)s')
        logger.info('experiment %s -> %s', exp.exp_name, exp.exp_dir)

    def log_metrics(self, model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
        parts = ', '.join(f'{k}: {v:.4g}' for k, v in metrics.items())
        logger.info('[%s/%s] epoch %d: %s', model, source, epoch, parts)

    def stop(self) -> None:
        pass


class CSVDumper:
    """``metrics/<model>_<source>.csv`` under the experiment directory, one
    row an epoch; a resumed run appends under the file's header, and a
    metric that appears later extends the header by a rewrite."""

    def __init__(self) -> None:
        self.dir: pathlib.Path | None = None
        self._writers: dict[tuple[str, str], tuple[Any, csv.DictWriter, list[str]]] = {}

    def start(self, exp) -> None:
        self.dir = exp.exp_dir / 'metrics'
        self.dir.mkdir(parents=True, exist_ok=True)

    def log_metrics(self, model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
        if self.dir is None:
            return
        key = (model, source)
        row = {'epoch': epoch, **metrics}
        path = self.dir / f'{model}_{source}.csv'
        if key not in self._writers:
            fields: list[str] = []
            if path.exists() and path.stat().st_size > 0:
                with open(path, newline='') as rf:
                    fields = next(csv.reader(rf), []) or []
            existing = list(fields)
            fields += [f for f in row if f not in fields]
            if existing and fields != existing:
                self._rewrite(path, fields)
            fh = open(path, 'a', newline='')
            writer = csv.DictWriter(fh, fieldnames=fields, restval='')
            if path.stat().st_size == 0:
                writer.writeheader()
            self._writers[key] = (fh, writer, fields)
        fh, writer, fields = self._writers[key]
        new = [f for f in row if f not in fields]
        if new:
            fields = fields + new
            fh.close()
            self._rewrite(path, fields)
            fh = open(path, 'a', newline='')
            writer = csv.DictWriter(fh, fieldnames=fields, restval='')
            self._writers[key] = (fh, writer, fields)
        writer.writerow(row)
        fh.flush()

    @staticmethod
    def _rewrite(path: pathlib.Path, fields: list[str]) -> None:
        rows: list[dict[str, Any]] = []
        if path.exists() and path.stat().st_size > 0:
            with open(path, newline='') as rf:
                rows = list(csv.DictReader(rf))
        with open(path, 'w', newline='') as wf:
            writer = csv.DictWriter(wf, fieldnames=fields, restval='')
            writer.writeheader()
            for r in rows:
                writer.writerow({k: v for k, v in r.items() if k in fields})

    def stop(self) -> None:
        for fh, _, _ in self._writers.values():
            fh.close()
        self._writers = {}


class SQLiteTracker:
    """``metrics.db``: one table of (model, source, epoch, name, value)."""

    def __init__(self) -> None:
        self.conn: sqlite3.Connection | None = None

    def start(self, exp) -> None:
        self.conn = sqlite3.connect(exp.exp_dir / 'metrics.db')
        self.conn.execute('CREATE TABLE IF NOT EXISTS metrics (model TEXT, source TEXT, epoch INTEGER, name TEXT, '
                          'value REAL)')
        self.conn.commit()

    def log_metrics(self, model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
        if self.conn is None:
            return
        self.conn.executemany('INSERT INTO metrics VALUES (?, ?, ?, ?, ?)',
                              [(model, source, epoch, k, float(v)) for k, v in metrics.items()])
        self.conn.commit()

    def stop(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


class HydraLinkTracker:
    """A copy of ``config.json`` as ``composed_config.json``."""

    def start(self, exp) -> None:
        src = exp.exp_dir / 'config.json'
        try:
            if not src.exists():
                exp.dump_config()
            shutil.copyfile(src, exp.exp_dir / 'composed_config.json')
        except OSError as err:
            logger.warning('could not persist composed config: %s', err)

    def log_metrics(self, **kwargs) -> None:
        pass

    def stop(self) -> None:
        pass


class TensorBoardTracker(_CurrentMixin):
    """tensorboardX event files under ``exp_dir/tb``."""

    def __init__(self) -> None:
        from tensorboardX import SummaryWriter

        self._writer_cls = SummaryWriter
        self.writer = None

    def start(self, exp) -> None:
        self.writer = self._writer_cls(logdir=str(exp.exp_dir / 'tb'))
        TensorBoardTracker._current = self

    def log_metrics(self, model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
        if self.writer is not None:
            for name, value in metrics.items():
                self.writer.add_scalar(f'{model}/{source}/{name}', value, epoch)

    def stop(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if TensorBoardTracker._current is self:
            TensorBoardTracker._current = None


class WandbTracker(_CurrentMixin):
    def __init__(self) -> None:
        import wandb

        self._wandb = wandb
        self.run = None

    def start(self, exp) -> None:
        self.run = self._wandb.init(project=f'PointCloudCounterfactualv{VERSION}', name=exp.exp_name,
                                    tags=exp.tags)
        WandbTracker._current = self

    def log_metrics(self, model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
        if self.run is not None:
            self.run.log({f'{model}/{source}/{k}': v for k, v in metrics.items()}, step=epoch)

    def stop(self) -> None:
        if self.run is not None:
            self.run.finish()
        if WandbTracker._current is self:
            WandbTracker._current = None


def get_trackers(cfg) -> list[Any]:
    """The trackers ``cfg.user.trackers`` asks for, the logger first."""
    trackers: list[Any] = [BuiltinLogger()]
    flags = cfg.user.trackers
    if flags.csv:
        trackers.append(CSVDumper())
    if flags.hydra:
        trackers.append(HydraLinkTracker())
    if flags.tensorboard:
        try:
            trackers.append(TensorBoardTracker())
        except ImportError:
            logger.info('tensorboardX unavailable; skipping TensorBoard tracker')
    if flags.sqlalchemy:
        trackers.append(SQLiteTracker())
    if flags.wandb:
        try:
            trackers.append(WandbTracker())
        except ImportError:
            logger.info('wandb unavailable; skipping tracker')
    return trackers


def dispatch_metrics(model: str, source: str, epoch: int, metrics: dict[str, float]) -> None:
    """Hand a row to the current experiment's trackers, if a run is on and
    this is rank 0 of a data-parallel run (or the only process)."""
    if not mesh.is_main_process():
        return
    try:
        exp = Experiment.current()
    except RuntimeError:
        return
    for tracker in exp.trackers:
        log = getattr(tracker, 'log_metrics', None)
        if log:
            log(model=model, source=source, epoch=epoch, metrics=metrics)

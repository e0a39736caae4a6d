"""The hyper-parameter study engine: a copy of ``pccf/utils/tuning.py``
(numpy and sqlite3 only), which imports nothing of JAX or ``pccf``.  The
port's tuning entry points (:mod:`pccf_torch.tune_autoencoder`,
:mod:`pccf_torch.tune_w_autoencoder`) run it; ``tests/test_torch_port_tuning.py``
holds it to the original on the same seeds.  What differs: the
:class:`TrialCallback` reads the port's trainer, :func:`run_study` composes
through :mod:`pccf_torch.compose` with the port's ``VERSION``, and
:func:`visualize_study` logs one line and draws nothing where matplotlib
does not import.  It carries, as the original does:

- sqlite-backed ``Study`` with resumable trials, direction, user attrs;
- samplers: random, a TPE-style quantile sampler, and a Gaussian-process
  sampler with expected-improvement acquisition (the reference studies run
  ``optuna.samplers.GPSampler`` — tune_autoencoder.py:60);
- ``MedianPruner`` (n_startup_trials / n_warmup_steps / interval_steps /
  n_min_trials);
- ``Trial.suggest_{float,int,categorical}`` + the variable-length
  ``suggest_list`` override form used by the tuning YAML tree
  (configs/tuning/autoencoder/tune/decoder.yaml);
- ``suggest_overrides`` mapping the tuning YAML to Hydra-style overrides;
- imputation of pruned/failed trials (percentile / worst-value);
- matplotlib study visualisation.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pathlib
import sqlite3
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

logger = logging.getLogger('pccf_torch')


class TrialPruned(Exception):
    """Raised to stop an unpromising trial (optuna.TrialPruned parity)."""


class TrialState:
    RUNNING = 'RUNNING'
    COMPLETE = 'COMPLETE'
    PRUNED = 'PRUNED'
    FAIL = 'FAIL'


@dataclass
class FrozenTrial:
    number: int
    state: str
    value: float | None
    params: dict[str, Any] = field(default_factory=dict)
    intermediate_values: dict[int, float] = field(default_factory=dict)
    user_attrs: dict[str, Any] = field(default_factory=dict)


class MedianPruner:
    """Prune when the intermediate value is worse than the running median of
    prior trials at the same step."""

    def __init__(
        self,
        n_startup_trials: int = 5,
        n_warmup_steps: int = 0,
        interval_steps: int = 1,
        n_min_trials: int = 1,
    ) -> None:
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = max(1, interval_steps)
        self.n_min_trials = n_min_trials

    def should_prune(self, study: 'Study', trial: 'Trial') -> bool:
        steps = sorted(trial.intermediate_values)
        if not steps:
            return False
        step = steps[-1]
        if step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps != 0:
            return False
        completed = [
            t for t in study.get_trials() if t.state == TrialState.COMPLETE and t.number != trial.number
        ]
        if len(completed) < self.n_startup_trials:
            return False
        # optuna MedianPruner semantics: the median is over completed trials'
        # values AT this step (their running best would bias the bar low for
        # noisy metrics and prune good-but-noisy configurations); NaNs are
        # excluded from the baseline
        at_step = [
            t.intermediate_values[step]
            for t in completed
            if step in t.intermediate_values
        ]
        at_step = [v for v in at_step if not math.isnan(v)]
        if len(at_step) < self.n_min_trials:
            return False
        median = float(np.median(at_step))
        # ...while the candidate side uses the trial's BEST value so far — a
        # noisy spike at the current epoch must not kill a trial whose
        # smoothed best beats the median
        trial_vals = [v for s, v in trial.intermediate_values.items() if s <= step]
        finite = [v for v in trial_vals if not math.isnan(v)]
        if not finite:
            return True  # every reported value is NaN: the trial diverged
        value = min(finite) if study.direction == 'minimize' else max(finite)
        return value > median if study.direction == 'minimize' else value < median


class RandomSampler:
    def __init__(self, seed: int = 0) -> None:
        self.rng = np.random.default_rng(seed)

    def sample(
        self, study: 'Study', name: str, dist: dict[str, Any], trial: 'Trial | None' = None
    ) -> Any:
        del trial
        return _sample_from_dist(self.rng, dist)


class TPESampler(RandomSampler):
    """Quantile-guided sampler: after ``n_startup`` random trials, sample near
    parameter values drawn from the best-quartile trials (simplified TPE)."""

    def __init__(self, seed: int = 0, n_startup: int = 10, gamma: float = 0.25) -> None:
        super().__init__(seed)
        self.n_startup = n_startup
        self.gamma = gamma

    def sample(
        self, study: 'Study', name: str, dist: dict[str, Any], trial: 'Trial | None' = None
    ) -> Any:
        del trial
        completed = [
            t for t in study.get_trials()
            if t.state == TrialState.COMPLETE and t.value is not None and name in t.params
        ]
        if len(completed) < self.n_startup or self.rng.random() < 0.25:
            return _sample_from_dist(self.rng, dist)
        completed.sort(key=lambda t: t.value, reverse=study.direction == 'maximize')
        good = completed[: max(1, int(len(completed) * self.gamma))]
        base = good[int(self.rng.integers(len(good)))].params[name]
        kind = dist['kind']
        if kind == 'categorical':
            return base if self.rng.random() < 0.7 else _sample_from_dist(self.rng, dist)
        low, high = dist['low'], dist['high']
        if dist.get('log'):
            sigma = (math.log(high) - math.log(low)) * 0.15
            val = math.exp(self.rng.normal(math.log(float(base)), sigma))
        else:
            sigma = (high - low) * 0.15
            val = self.rng.normal(float(base), sigma)
        val = min(max(val, low), high)
        return int(round(val)) if kind == 'int' else float(val)


class GPSampler(RandomSampler):
    """Gaussian-process sampler with expected-improvement acquisition.

    Native stand-in for ``optuna.samplers.GPSampler`` (the sampler the
    reference studies run — the reference's tune_autoencoder.py:60,
    tune_w_autoencoder.py:86).  Because pccf samples one parameter at a
    time, each suggestion maximises EI *conditionally*: candidate vectors fix
    the parameters this trial has already chosen, vary ``name`` over its
    distribution, and marginalise the not-yet-suggested keys with random
    fills.  The GP is an RBF kernel over [0, 1]-normalised parameters
    (log-warped for log distributions) with a median-heuristic lengthscale
    and standardised targets.
    """

    def __init__(
        self,
        seed: int = 0,
        n_startup: int = 10,
        n_candidates: int = 512,
        noise: float = 1e-4,
        max_fit_trials: int = 200,
        explore_prob: float = 0.05,
    ) -> None:
        super().__init__(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.noise = noise
        self.max_fit_trials = max_fit_trials
        self.explore_prob = explore_prob

    def sample(
        self, study: 'Study', name: str, dist: dict[str, Any], trial: 'Trial | None' = None
    ) -> Any:
        completed = [
            t for t in study.get_trials()
            if t.state == TrialState.COMPLETE and t.value is not None and name in t.params
        ]
        if len(completed) < self.n_startup or self.rng.random() < self.explore_prob:
            return _sample_from_dist(self.rng, dist)
        completed = completed[-self.max_fit_trials:]

        keys = sorted(set.intersection(*(set(t.params) for t in completed)))
        if name not in keys:
            return _sample_from_dist(self.rng, dist)
        encoders = {
            k: (_DistEncoder(dist) if k == name else _ValueEncoder([t.params[k] for t in completed]))
            for k in keys
        }
        x_fit = np.array([[encoders[k].encode(t.params[k]) for k in keys] for t in completed])
        y = np.array([t.value for t in completed], dtype=np.float64)
        if study.direction == 'minimize':
            y = -y  # GP/EI below maximise
        y_std = y.std()
        y_n = (y - y.mean()) / (y_std if y_std > 1e-12 else 1.0)

        # candidate matrix: already-chosen params fixed, `name` swept over its
        # distribution, future params filled uniformly (marginalised).
        chosen = dict(trial.params) if trial is not None else {}
        n_c = self.n_candidates
        cand = self.rng.uniform(size=(n_c, len(keys)))
        raw_name: list[Any] = []
        for j, k in enumerate(keys):
            if k == name:
                raw_name = [_sample_from_dist(self.rng, dist) for _ in range(n_c)]
                cand[:, j] = [encoders[k].encode(v) for v in raw_name]
            elif k in chosen:
                cand[:, j] = encoders[k].encode(chosen[k])

        ei = _gp_expected_improvement(x_fit, y_n, cand, self.noise)
        return raw_name[int(np.argmax(ei))]


class _DistEncoder:
    """[0,1] encoding driven by the live distribution spec."""

    def __init__(self, dist: dict[str, Any]) -> None:
        self.dist = dist

    def encode(self, value: Any) -> float:
        d = self.dist
        if d['kind'] == 'categorical':
            choices = d['choices']
            idx = choices.index(value) if value in choices else 0
            return idx / max(1, len(choices) - 1)
        low, high = float(d['low']), float(d['high'])
        if d.get('log'):
            low, high, value = math.log(low), math.log(high), math.log(float(value))
        else:
            value = float(value)
        span = high - low
        return (value - low) / span if span > 0 else 0.5


class _ValueEncoder:
    """[0,1] encoding of an already-observed parameter column (its original
    distribution spec is not persisted, so normalise empirically)."""

    def __init__(self, values: list[Any]) -> None:
        if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
            self.categories: list[Any] | None = None
            self.low = float(min(values))
            self.high = float(max(values))
        else:
            self.categories = sorted({repr(v) for v in values})
            self.low = 0.0
            self.high = float(max(1, len(self.categories) - 1))

    def encode(self, value: Any) -> float:
        if self.categories is not None:
            r = repr(value)
            pos = self.categories.index(r) if r in self.categories else 0
            return pos / self.high if self.high > 0 else 0.5
        span = self.high - self.low
        return (float(value) - self.low) / span if span > 0 else 0.5


def _gp_expected_improvement(
    x_fit: np.ndarray, y: np.ndarray, cand: np.ndarray, noise: float
) -> np.ndarray:
    """EI of maximisation-form targets under an RBF GP posterior."""
    d2 = ((x_fit[:, None, :] - x_fit[None, :, :]) ** 2).sum(-1)
    off = d2[np.triu_indices_from(d2, k=1)]
    med = np.median(off[off > 0]) if np.any(off > 0) else 1.0
    ls2 = max(med, 1e-8)
    k_xx = np.exp(-0.5 * d2 / ls2) + noise * np.eye(len(x_fit))
    chol = np.linalg.cholesky(k_xx)
    alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, y))

    d2_c = ((cand[:, None, :] - x_fit[None, :, :]) ** 2).sum(-1)
    k_c = np.exp(-0.5 * d2_c / ls2)
    mu = k_c @ alpha
    v = np.linalg.solve(chol, k_c.T)
    var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
    sigma = np.sqrt(var)

    best = y.max()
    z = (mu - best) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * z**2) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf


def _sample_from_dist(rng: np.random.Generator, dist: dict[str, Any]) -> Any:
    kind = dist['kind']
    if kind == 'categorical':
        choices = dist['choices']
        return choices[int(rng.integers(len(choices)))]
    low, high = dist['low'], dist['high']
    if kind == 'int':
        if dist.get('log'):
            return int(round(math.exp(rng.uniform(math.log(low), math.log(high)))))
        return int(rng.integers(low, high + 1))
    if dist.get('log'):
        return float(math.exp(rng.uniform(math.log(low), math.log(high))))
    return float(rng.uniform(low, high))


class Trial:
    """A live trial: parameter suggestion + intermediate reporting."""

    def __init__(self, study: 'Study', number: int) -> None:
        self.study = study
        self.number = number
        self.params: dict[str, Any] = {}
        self.intermediate_values: dict[int, float] = {}
        self.user_attrs: dict[str, Any] = {}
        self._last_value: float | None = None

    # ------------------------------------------------------------- suggests
    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        return self._suggest(name, {'kind': 'float', 'low': low, 'high': high, 'log': log})

    def suggest_int(self, name: str, low: int, high: int, log: bool = False) -> int:
        return self._suggest(name, {'kind': 'int', 'low': low, 'high': high, 'log': log})

    def suggest_categorical(self, name: str, choices: list[Any]) -> Any:
        return self._suggest(name, {'kind': 'categorical', 'choices': list(choices)})

    def _suggest(self, name: str, dist: dict[str, Any]) -> Any:
        if name in self.params:
            return self.params[name]
        value = self.study.sampler.sample(self.study, name, dist, trial=self)
        self.params[name] = value
        self.study._save_trial(self)
        return value

    # ------------------------------------------------------------ reporting
    def report(self, value: float, step: int) -> None:
        self.intermediate_values[int(step)] = float(value)
        self._last_value = float(value)
        self.study._save_trial(self)

    def should_prune(self) -> bool:
        return self.study.pruner.should_prune(self.study, self)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value
        self.study._save_trial(self)

    @property
    def last_value(self) -> float | None:
        return self._last_value


class Study:
    """sqlite-backed optimisation study."""

    def __init__(
        self,
        study_name: str,
        storage: str | pathlib.Path,
        direction: str = 'minimize',
        sampler: Any = None,
        pruner: MedianPruner | None = None,
    ) -> None:
        self.study_name = study_name
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or MedianPruner()
        path = str(storage).replace('sqlite:///', '')
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            'CREATE TABLE IF NOT EXISTS trials (study TEXT, number INTEGER, state TEXT, '
            'value REAL, params TEXT, intermediate TEXT, user_attrs TEXT, ts REAL, '
            'PRIMARY KEY (study, number))'
        )
        self.conn.commit()

    # -------------------------------------------------------------- storage
    def get_trials(self, deepcopy: bool = False) -> list[FrozenTrial]:
        del deepcopy
        rows = self.conn.execute(
            'SELECT number, state, value, params, intermediate, user_attrs FROM trials '
            'WHERE study = ? ORDER BY number',
            (self.study_name,),
        ).fetchall()
        return [
            FrozenTrial(
                number=r[0],
                state=r[1],
                value=r[2],
                params=json.loads(r[3] or '{}'),
                intermediate_values={int(k): v for k, v in json.loads(r[4] or '{}').items()},
                user_attrs=json.loads(r[5] or '{}'),
            )
            for r in rows
        ]

    def _save_trial(self, trial: Trial, state: str = TrialState.RUNNING, value: float | None = None) -> None:
        self.conn.execute(
            'INSERT OR REPLACE INTO trials VALUES (?, ?, ?, ?, ?, ?, ?, ?)',
            (
                self.study_name,
                trial.number,
                state,
                value,
                json.dumps(trial.params),
                json.dumps(trial.intermediate_values),
                json.dumps(trial.user_attrs),
                time.time(),
            ),
        )
        self.conn.commit()

    def _claim_trial_number(self) -> int:
        """Atomically allocate the next trial number.

        BEGIN IMMEDIATE takes the sqlite write lock before reading
        MAX(number), so two processes optimizing the same study (the standard
        optuna parallelisation pattern) can never claim — and silently
        overwrite — the same trial row."""
        for _ in range(200):
            try:
                self.conn.execute('BEGIN IMMEDIATE')
                row = self.conn.execute(
                    'SELECT COALESCE(MAX(number), -1) + 1 FROM trials WHERE study = ?',
                    (self.study_name,),
                ).fetchone()
                number = int(row[0])
                self.conn.execute(
                    'INSERT INTO trials VALUES (?, ?, ?, ?, ?, ?, ?, ?)',
                    (self.study_name, number, TrialState.RUNNING, None, '{}', '{}', '{}', time.time()),
                )
                self.conn.commit()
                return number
            except sqlite3.Error:
                self.conn.rollback()
                time.sleep(0.01)
        raise RuntimeError('could not claim a trial number (storage contended)')

    # ----------------------------------------------------------- optimise
    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        catch: tuple[type[BaseException], ...] = (),
    ) -> None:
        """Run ``n_trials`` trials (optuna semantics: an exception not in
        ``catch`` is recorded as FAIL and then PROPAGATES, halting the study
        loudly instead of silently burning every remaining trial)."""
        import sys
        import traceback

        for _ in range(n_trials):
            number = self._claim_trial_number()
            trial = Trial(self, number)
            try:
                value = objective(trial)
            except TrialPruned:
                self._save_trial(trial, TrialState.PRUNED, None)
                continue
            except catch:
                print(
                    f'Trial {number} failed:\n{traceback.format_exc()}', file=sys.stderr
                )
                self._save_trial(trial, TrialState.FAIL, None)
                continue
            except BaseException:
                self._save_trial(trial, TrialState.FAIL, None)
                raise
            self._save_trial(trial, TrialState.COMPLETE, float(value))

    @property
    def best_trial(self) -> FrozenTrial:
        completed = [t for t in self.get_trials() if t.state == TrialState.COMPLETE and t.value is not None]
        if not completed:
            raise ValueError('No completed trials.')
        return (min if self.direction == 'minimize' else max)(completed, key=lambda t: t.value)

    @property
    def best_params(self) -> dict[str, Any]:
        return self.best_trial.params


def create_study(
    study_name: str,
    storage: str,
    direction: str = 'minimize',
    sampler: Any = None,
    pruner: MedianPruner | None = None,
    load_if_exists: bool = True,
) -> Study:
    del load_if_exists  # studies always resume from the sqlite storage
    return Study(study_name, storage, direction, sampler, pruner)


# --------------------------------------------------------------- integration


class TrialCallback:
    """Post-epoch hook: report the smoothed validation metric, prune if told
    (``pccf/utils/tuning.py`` ``TrialCallback``): the monitored value of the
    trainer's latest validation row (the training row without validation)
    through ``filter_fn`` of its history, reported at the completed epoch."""

    def __init__(self, trial: Trial, metric: Any, filter_fn: Callable[[list[float]], float] | None = None):
        self.trial = trial
        self.metric = metric
        self.metric_name = metric.name
        self.filter_fn = filter_fn or (lambda h: h[-1])
        self.history: list[float] = []

    def __call__(self, trainer: Any) -> None:
        from pccf_torch.train.hooks import resolve_monitored_value

        log = trainer.validation_log or trainer.metrics_log
        if not log:
            return
        self.metric_name, value = resolve_monitored_value(self.metric, log[-1])
        if value is None:
            # composite metric: first component available
            value = next(iter(log[-1].values()))
        self.history.append(float(value))
        smoothed = self.filter_fn(self.history)
        self.trial.report(smoothed, step=trainer.epoch)
        if self.trial.should_prune():
            raise TrialPruned()


def get_final_value(trial: Trial) -> float:
    """Final (last reported) value of the trial."""
    if trial.last_value is None:
        raise ValueError('Trial reported no values.')
    return trial.last_value


def suggest_overrides(tune_cfg: dict[str, Any], trial: Trial) -> list[str]:
    """Map the tuning YAML ``params`` tree to Hydra-style overrides.

    Supports suggest_float / suggest_int / suggest_categorical and the
    variable-length ``suggest_list`` form (drytorch.contrib.optuna parity;
    see configs/tuning/autoencoder/tune/decoder.yaml)."""
    overrides = list(tune_cfg.get('overrides', []))
    params = tune_cfg.get('tune', {}).get('params', {})
    for key, spec in params.items():
        suggest = spec['suggest']
        settings = spec.get('settings', {})
        if suggest == 'suggest_list':
            min_len = settings['min_length']
            max_len = settings['max_length']
            inner = settings['suggest']
            inner_settings = settings.get('settings', {})
            length = trial.suggest_int(f'{key}.length', min_len, max_len)
            values = [
                _suggest_one(trial, f'{key}.{i}', inner, inner_settings) for i in range(length)
            ]
            overrides.append(f'{key}=[{",".join(str(v) for v in values)}]')
        else:
            value = _suggest_one(trial, key, suggest, settings)
            overrides.append(f'{key}={value}')
    return overrides


def _suggest_one(trial: Trial, name: str, suggest: str, settings: dict[str, Any]) -> Any:
    if suggest == 'suggest_float':
        return trial.suggest_float(name, settings['low'], settings['high'], settings.get('log', False))
    if suggest == 'suggest_int':
        return trial.suggest_int(name, settings['low'], settings['high'], settings.get('log', False))
    if suggest == 'suggest_categorical':
        return trial.suggest_categorical(name, settings['choices'])
    raise ValueError(f'Unknown suggest kind {suggest}')


# ---------------------------------------------------------------- imputation


def get_past_final_values(trial: Trial) -> list[float]:
    """Final values of real (non-imputed) completed trials (reference
    src/utils/tuning.py:11-27); prunes when fewer than 10 exist."""
    past = [
        t for t in trial.study.get_trials()
        if t.number != trial.number
        and t.state == TrialState.COMPLETE
        and t.value is not None
        and not t.user_attrs.get('imputed', False)
    ]
    if len(past) < 10:
        raise TrialPruned()
    return [t.value for t in past]


def impute_pruned_trial(trial: Trial) -> float:
    """75th (min) / 25th (max) percentile imputation (tuning.py:30-37)."""
    values = get_past_final_values(trial)
    pct = 75 if trial.study.direction == 'minimize' else 25
    trial.set_user_attr('imputed', True)
    return float(np.percentile(values, pct))


def impute_failed_trial(trial: Trial) -> float:
    """Worst-completed-value imputation (tuning.py:40-45)."""
    values = get_past_final_values(trial)
    worst = max if trial.study.direction == 'minimize' else min
    trial.set_user_attr('imputed', True)
    return float(worst(values))


# ------------------------------------------------------------- visualisation


def visualize_study(study: Study, save_dir: str | pathlib.Path, renderer: str = '') -> list[pathlib.Path]:
    """History / slice plots saved as PNGs (pyvista/plotly-free); none, and
    one log line, where matplotlib does not import."""
    del renderer
    try:
        import matplotlib
    except ImportError:
        logger.info('visualize_study: matplotlib does not import; study %s not drawn', study.study_name)
        return []

    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    trials = [t for t in study.get_trials() if t.state == TrialState.COMPLETE and t.value is not None]
    out = []
    if not trials:
        return out
    fig, ax = plt.subplots()
    ax.plot([t.number for t in trials], [t.value for t in trials], 'o-')
    ax.set_xlabel('trial')
    ax.set_ylabel('value')
    ax.set_title(f'{study.study_name}: optimization history')
    p = save_dir / 'history.png'
    fig.savefig(p, dpi=100)
    plt.close(fig)
    out.append(p)
    # per-parameter slice
    keys = sorted({k for t in trials for k in t.params if isinstance(t.params[k], (int, float))})
    for key in keys[:12]:
        xs = [t.params[key] for t in trials if key in t.params]
        ys = [t.value for t in trials if key in t.params]
        fig, ax = plt.subplots()
        ax.scatter(xs, ys)
        ax.set_xlabel(key)
        ax.set_ylabel('value')
        p = save_dir / f'slice_{key.replace(".", "_")}.png'
        fig.savefig(p, dpi=100)
        plt.close(fig)
        out.append(p)
    return out


def make_sampler(kind: str, n_startup: int = 10, seed: int | None = None) -> RandomSampler:
    """Config-driven sampler selection (``configs/tuning/optuna.yaml``).

    ``gp`` matches the reference's optuna GPSampler choice
    (the reference's tune_autoencoder.py:60).  ``seed=None`` draws fresh OS
    entropy (optuna's default): a fixed default seed would make every
    resumed/parallel worker replay the identical suggestion sequence, so
    restarts duplicate earlier trials and concurrent workers explore the
    same points."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), 'little')
    kinds = {
        'gp': lambda: GPSampler(seed=seed, n_startup=n_startup),
        'tpe': lambda: TPESampler(seed=seed, n_startup=n_startup),
        'random': lambda: RandomSampler(seed=seed),
    }
    if kind not in kinds:
        raise ValueError(f'Unknown sampler {kind!r}; choose from {sorted(kinds)}')
    return kinds[kind]()


def get_study_name(version: str, variation: str, tuning_scheme: str, overrides: list[str]) -> str:
    """Study naming (reference tuning.py:58-66)."""
    reprs = (ov.rsplit('.', maxsplit=1)[-1].rsplit('/', maxsplit=1)[-1] for ov in overrides)
    return '_'.join([version, variation, *reprs, tuning_scheme])


def run_study(tuning_dir: str | pathlib.Path, set_objective, argv: list[str] | None = None) -> Study:
    """Compose the tuning YAML, build pruner/sampler/study, and optimize.

    Shared runner of the two tuning entry points (the reference duplicates
    this block in tune_autoencoder.py:49-67 and tune_w_autoencoder.py);
    ``set_objective(tune_cfg) -> objective(trial)`` supplies the per-script
    trial body.  ``+tune.seed=N`` seeds the sampler, so that a run repeats
    its suggestions (``chip_smoke.py``); without it the sampler draws fresh
    entropy, as JAX's engine does."""
    import sys

    from pccf_torch.compose import compose
    from pccf_torch.config import VERSION

    argv = sys.argv[1:] if argv is None else argv
    tune_cfg = compose(pathlib.Path(tuning_dir), 'defaults', overrides=argv)
    pathlib.Path(tune_cfg['db_location']).mkdir(parents=True, exist_ok=True)
    t = tune_cfg['tune']
    pruner = MedianPruner(
        n_startup_trials=t['n_startup_trials'],
        n_warmup_steps=t['n_warmup_steps'],
        interval_steps=t['interval_steps'],
        n_min_trials=t['n_min_trials'],
    )
    study_name = get_study_name(
        f'v{VERSION}', 'main', t['study_name'], tune_cfg.get('overrides', [])
    )
    study = create_study(
        study_name=study_name, storage=tune_cfg['storage'], pruner=pruner,
        sampler=make_sampler(t.get('sampler', 'gp'), n_startup=t['n_startup_trials'], seed=t.get('seed')),
    )
    study.optimize(set_objective(tune_cfg), n_trials=t['n_trials'])
    visualize_study(study, pathlib.Path(tune_cfg['db_location']) / study_name)
    return study

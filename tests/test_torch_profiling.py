"""The marginal timer (``pccf_torch/utils/timing.py``) and the stage-attribution
scripts on the CPU.

- ``marginal_time``'s arithmetic on a stub clock that each step advances:
  the best of the repeats at each chain length, their difference over the
  lengths' difference;
- a marginal that is not positive measured again with three times the
  repeats, then raising (never clamped);
- each script's ``main`` (``profile_cf``, ``profile_enc``, ``profile_wae``,
  ``tools/profile_train``) at a tiny size with chains of 1 and 2, printing
  the JAX scripts' lines, every time positive.
"""

import json

import pytest
import torch

from pccf_torch import profile_cf, profile_enc, profile_wae
from pccf_torch.tools import profile_train
from pccf_torch.utils import timing
from tests.test_pipeline import TINY

torch.set_num_threads(1)

# the tiny widths of tests/test_pipeline.py, the sizes left to each main
WIDTHS = tuple(o for o in TINY if not o.startswith(('data/dataset', 'data.dataset.n_classes', 'data.n_input',
                                                    'data.n_target', 'autoencoder.objective',
                                                    'autoencoder.train.batch')))


class StubClock:
    """A clock the steps advance: ``cost(k)`` seconds for the k-th step
    called, plus ``overhead`` for each chain (read at its start)."""

    def __init__(self, cost, overhead=0.0):
        self.t, self.calls, self.reads, self.cost, self.overhead = 0.0, 0, 0, cost, overhead

    def __call__(self):
        self.reads += 1
        if self.reads % 2 == 1:
            self.t += self.overhead
        return self.t

    def step(self, carry):
        self.calls += 1
        self.t += self.cost(self.calls)
        return carry + 1


@pytest.mark.parametrize('k_short,k_long,repeats', [(2, 12, 2), (1, 9, 3), (1, 2, 1)])
def test_marginal_time_arithmetic(k_short, k_long, repeats):
    clock = StubClock(lambda k: 0.25, overhead=3.0)
    got = timing.marginal_time(clock.step, torch.zeros(()), k_short, k_long, repeats, clock=clock)
    assert got == pytest.approx(0.25, rel=1e-12)
    # the warm chain, then each length ``repeats`` times
    assert clock.calls == k_short + repeats * (k_short + k_long)


def test_marginal_time_takes_the_best_of_the_repeats():
    # the warm chain, then a fast and a slow run of each length: the best of
    # each length is the fast one
    costs = iter([0.5] * 3 + [0.5] * 3 + [2.0] * 3 + [0.5] * 12 + [2.0] * 12)
    clock = StubClock(lambda k: next(costs))
    got = timing.marginal_time(clock.step, torch.zeros(()), 3, 12, 2, clock=clock)
    assert got == pytest.approx(0.5)


def test_non_positive_marginal_retries_then_raises():
    # long chains as fast as short ones: marginal 0, measured again with
    # three times the repeats, then an error
    clock = StubClock(lambda k: 0.0, overhead=1.0)
    with pytest.raises(RuntimeError, match='non-positive marginal'):
        timing.marginal_time(clock.step, torch.zeros(()), 2, 6, 2, clock=clock)
    assert clock.calls == 2 + 2 * (2 + 6) + 6 * (2 + 6)


def test_non_positive_marginal_recovers_on_the_retry():
    # the first round's long runs read fast (a noisy clock), the retry's right
    first_round = 2 + 2 * (2 + 6)
    clock = StubClock(lambda k: (0.0 if k <= first_round else 0.125))
    got = timing.marginal_time(clock.step, torch.zeros(()), 2, 6, 2, clock=clock)
    assert got == pytest.approx(0.125)


def test_marginal_time_refuses_lengths_out_of_order():
    with pytest.raises(ValueError, match='k_short < k_long'):
        timing.marginal_time(lambda c: c, torch.zeros(()), 3, 3)


def test_profile_cf_main(capsys):
    out = profile_cf.main(2, 64, 1, 2, 1, 'cpu', WIDTHS)
    assert list(out) == ['full', 'encoder', 'wae_inner', 'decode_pcgen'] and all(v > 0 for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(':')[0].strip() for ln in lines] == list(out)
    assert all('ms/batch' in ln and 'samples/s' in ln for ln in lines)


def test_profile_enc_main(capsys):
    out = profile_enc.main(2, 64, 6, 1, 2, 1, 'cpu')
    assert len(out) == 9 and all(v > 0 for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(':')[0] for ln in lines] == ['knn   c=   3', 'knn   c=  64', 'knn   c=  64', 'knn   c= 128',
                                                 'pool  c=  64', 'pool  c=  64', 'pool  c= 128', 'pool  c= 256',
                                                 'final conv 512->1024 + max']


def test_profile_wae_main(capsys):
    out = profile_wae.main(2, 64, 1, 2, 1, 'cpu', WIDTHS)
    assert list(out) == ['full_cf', 'z1_enc', 'z1+z2', 'z1+z2+decode'] and all(v > 0 for v in out.values())
    assert len(capsys.readouterr().out.splitlines()) == 4


def test_profile_train_main(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv('DATASET_DIR', str(tmp_path))
    out = profile_train.main(2, 64, 1, 2, 1, 'cpu', WIDTHS)
    assert set(out) == {'full_step_ms', 'fwd_eval_ms', 'fwd_train_ms', 'fwd_bwd_ms', 'encoder_fwd_ms',
                        'encoder_fwd_bwd_ms', 'encoder_eval_ms', 'decoder_fwd_bwd_ms', 'loss_ms', 'optimizer_ms',
                        'derived_decoder_loss_bwd_ms'}
    assert all(v > 0 for k, v in out.items() if k != 'derived_decoder_loss_bwd_ms')
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out

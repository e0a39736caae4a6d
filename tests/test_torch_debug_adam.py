"""The port's debug helpers (``pccf_torch/utils/debug.py``) and its Adam at
optax's ``eps_root`` / ``mu_dtype`` / ``nesterov``
(``pccf_torch/train/runners.py`` ``OptaxAdam``), on the CPU.

Debugging: a NaN made by a named layer raises in forward, naming it; a NaN
cloud raises in the encoder, naming its module; a NaN a kernel op makes
raises naming the op and the module; a NaN gradient raises in backward; nothing raises once the switch is off; a
request under the switch is bit-equal to one without it; ``profile_trace``
writes a trace; ``StepTimer`` gives JAX's ``summary`` on the same times.

Adam: three steps at each knob and at all three together against
``get_optimizer('Adam')`` of ``pccf/config/specs.py`` (the JAX trainer's
optax chain) under ``optax.inject_hyperparams``, the parameters within rtol
1e-5 and atol 1e-6 (``tests/test_torch_port_harness.py``'s tolerance for
the optimisers), the first moment in its type; a resume through the state a
checkpoint sidecar keeps, bit-equal to the steps run in memory; a
weights-only resume's counts; the configuration reading the knobs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pccf_torch import cli, config as tc
from pccf_torch.kernels import api
from pccf_torch.train.runners import OptaxAdam, align_counts, make_optimizer
from pccf_torch.utils import debug

from tests.test_torch_port_harness import SHAPES, _grads

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def switched_off():
    yield
    debug.disable_nan_debugging()


class Log(nn.Module):
    def forward(self, x):
        return torch.log(x)


class RootTimesZero(nn.Module):
    """Zero in forward at 0, NaN in backward (0 · ∞)."""

    def forward(self, x):
        return torch.sqrt(x) * 0.0


def test_a_nan_made_by_a_named_layer_raises_in_forward():
    model = nn.Sequential(nn.Linear(3, 3), Log())
    with torch.no_grad():
        model[0].weight.copy_(-torch.eye(3))
        model[0].bias.zero_()
    debug.enable_nan_debugging()
    with pytest.raises(FloatingPointError, match=r'NaN in the forward output of Sequential\.1 \(Log\), made by its '
                                                 r'own operations'):
        model(torch.ones(2, 3))


class Pool(nn.Module):
    def forward(self, x, idx):
        return api.graph_max_pool(x, idx)


def test_a_nan_cloud_raises_in_an_encoder_module():
    from pccf_torch.nn.encoders import DGCNNEncoder
    from pccf_torch.nn.layers import get_act, init_from_seed

    enc = DGCNNEncoder(32, 4, get_act('LeakyReLU')).eval()
    init_from_seed(enc, 0)
    cloud = torch.randn(1, 16, 3, generator=torch.Generator().manual_seed(0))
    cloud[0, 5, 1] = float('nan')
    debug.enable_nan_debugging()
    with pytest.raises(FloatingPointError, match=r'NaN in the forward output of DGCNNEncoder\.edge_conv\.0 '
                                                 r'\(EdgeConvBlock\)'):
        with torch.no_grad():
            enc(cloud)


def test_a_nan_from_a_kernel_op_names_the_op_and_the_module():
    x = torch.randn(1, 16, 8, generator=torch.Generator().manual_seed(1))
    idx = api.knn(x, 4)
    x[0, idx[0, 3, 1], 2] = float('nan')  # a neighbour's channel: the pool's output takes it
    debug.enable_nan_debugging()
    with pytest.raises(FloatingPointError, match=r'NaN in the output of the kernel op pccf::graph_max_pool in Pool'):
        with torch.no_grad():
            Pool()(x, idx)


def test_a_nan_gradient_raises_in_backward():
    model = nn.Sequential(nn.Linear(3, 3), RootTimesZero())
    with torch.no_grad():
        model[0].weight.zero_()
        model[0].bias.zero_()
    debug.enable_nan_debugging()
    out = model(torch.ones(2, 3)).sum()  # zero, finite
    with pytest.raises(FloatingPointError, match=r'NaN in the gradient of Sequential\.1 \(RootTimesZero\), made by '
                                                 r'its own backward'):
        out.backward()


def test_infs_raise_only_when_asked():
    model = nn.Sequential(Log())
    debug.enable_nan_debugging(infs=False)
    assert torch.isinf(model(torch.zeros(2))).all()
    debug.enable_nan_debugging()
    with pytest.raises(FloatingPointError, match='Inf in the forward output'):
        model(torch.zeros(2))


def test_nothing_raises_once_the_switch_is_off():
    model = nn.Sequential(nn.Linear(3, 3), Log(), RootTimesZero())
    debug.enable_nan_debugging()
    debug.disable_nan_debugging()
    x = torch.full((2, 3), -1.0, requires_grad=True)
    model(x).sum().backward()
    assert torch.isnan(model(x)).any()


def test_a_request_under_the_switch_is_bit_equal():
    from tests.test_torch_export import _clouds, models
    from pccf_torch.serve import CounterfactualServer

    srv = CounterfactualServer(*models(), buckets=(2,))
    clouds = _clouds(2, seed=0)
    want = srv.counterfactual(clouds, 1, sampling_seed=3)
    debug.enable_nan_debugging()
    np.testing.assert_array_equal(srv.counterfactual(clouds, 1, sampling_seed=3), want)


def test_profile_trace_writes_a_trace(tmp_path):
    with debug.profile_trace(tmp_path / 'trace'):
        torch.ones(8) @ torch.ones(8)
    files = list((tmp_path / 'trace').glob('*.json'))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_step_timer_summary_is_jaxs():
    from pccf.utils.debug import StepTimer as JaxTimer

    times = [0.25, 0.5, 0.125, 1.0, 0.75]
    ours, theirs = debug.StepTimer(), JaxTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert debug.StepTimer().summary() == {} == JaxTimer().summary()
    with ours:
        pass
    assert ours.summary()['count'] == 6.0


# ------------------------------------------------------------------ Adam

KNOBS = [{'eps_root': 1e-8}, {'mu_dtype': 'bfloat16'}, {'nesterov': True},
         {'eps_root': 1e-8, 'mu_dtype': 'bfloat16', 'nesterov': True}]


def _cfg(settings, weight_decay=0.01):
    return dataclasses.replace(tc.AutoEncoderTrainConfig(), optimizer_name='Adam', weight_decay=weight_decay,
                               opt_settings=tuple(settings.items()))


def _init():
    return {k: np.random.default_rng(7).standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _steps(params, opt, steps, lrs=(0.1, 0.05, 0.02, 0.05, 0.01)):
    for step in steps:
        grads = _grads(step)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        for group in opt.param_groups:
            group['lr'] = lrs[step]
        opt.step()


@pytest.mark.parametrize('weight_decay', [0.0, 0.01])
@pytest.mark.parametrize('settings', KNOBS, ids=lambda s: '+'.join(s))
def test_adam_knobs_match_optax(settings, weight_decay):
    import optax

    from pccf.config.specs import get_optimizer

    init = _init()
    params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(_cfg(settings, weight_decay), list(params.values()), 0.1)
    assert isinstance(opt, OptaxAdam)
    tx = optax.inject_hyperparams(lambda lr: get_optimizer('Adam')(lr, weight_decay=weight_decay, **settings))(lr=0.1)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for step, lr in enumerate((0.1, 0.05, 0.02)):
        _steps(params, opt, [step])
        state.hyperparams['lr'] = jnp.asarray(lr)
        updates, state = tx.update({k: jnp.asarray(g) for k, g in _grads(step).items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in SHAPES:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=(settings, step, k))
    mu = state.inner_state[1][0].mu
    for i, k in enumerate(SHAPES):
        moment = opt.state[params[k]]['mu']
        assert moment.dtype == (torch.bfloat16 if settings.get('mu_dtype') else torch.float32)
        assert str(mu[k].dtype) == str(moment.dtype).split('.')[-1]
        np.testing.assert_array_equal(moment.float().numpy(), np.asarray(mu[k], np.float32))


@pytest.mark.parametrize('settings', KNOBS[1:], ids=lambda s: '+'.join(s))
def test_adam_knobs_resume_exactly(tmp_path, settings):
    """The state through ``torch.save`` and ``load_state_dict`` (the
    checkpoint sidecar's path): 3 steps, the state saved, a fresh optimiser
    loading it for 2 more, bit-equal to 5 steps; the first moment keeps its
    type across the load."""
    cfg = _cfg(settings)
    whole = {k: nn.Parameter(torch.from_numpy(v)) for k, v in _init().items()}
    _steps(whole, make_optimizer(cfg, list(whole.values()), 0.05), range(5))
    first = {k: nn.Parameter(torch.from_numpy(v)) for k, v in _init().items()}
    opt = make_optimizer(cfg, list(first.values()), 0.05)
    _steps(first, opt, range(3))
    torch.save(opt.state_dict(), tmp_path / 'opt')
    resumed = make_optimizer(cfg, list(first.values()), 0.05)
    resumed.load_state_dict(torch.load(tmp_path / 'opt', weights_only=False))
    assert {s['mu'].dtype for s in resumed.state.values()} == {s['mu'].dtype for s in opt.state.values()}
    _steps(first, resumed, range(3, 5))
    assert all(torch.equal(first[k], whole[k]) for k in SHAPES)


def test_adam_weights_only_resume_continues_the_count():
    params = {k: nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()}
    opt = make_optimizer(_cfg({'nesterov': True, 'mu_dtype': 'bfloat16'}), list(params.values()), 0.1)
    align_counts(opt, 12)
    for p in params.values():
        state = opt.state[p]
        assert state['count'] == 12 and state['mu'].dtype == torch.bfloat16 and not state['nu'].any()


def test_adam_knobs_read_from_the_tree():
    """``ADAM_FIXED`` is gone: the knobs compose, and a default Adam keeps
    ``torch.optim.Adam``."""
    base = ['classifier.train.learn.optimizer_name=Adam']
    cfg = cli.get_config([*base, '+classifier.train.learn.opt_settings.nesterov=true',
                          '+classifier.train.learn.opt_settings.eps_root=1e-8',
                          '+classifier.train.learn.opt_settings.mu_dtype=bfloat16'])[0].classifier.train
    assert dict(cfg.opt_settings) == {'nesterov': True, 'eps_root': 1e-8, 'mu_dtype': 'bfloat16'}
    p = [nn.Parameter(torch.zeros(2))]
    assert isinstance(make_optimizer(cfg, p, 0.1), OptaxAdam)
    plain = cli.get_config(base)[0].classifier.train
    assert type(make_optimizer(plain, p, 0.1)) is torch.optim.Adam
    assert not hasattr(tc, 'ADAM_FIXED')
    with pytest.raises(ValueError, match='mu_dtype'):
        cli.get_config([*base, '+classifier.train.learn.opt_settings.mu_dtype=int8'])

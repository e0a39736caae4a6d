"""The stage-2 modules of pccf_torch against the JAX package, on the CPU.

The W-nets' transformer stacks (the plain version of the ``wformer`` kernels,
which an eval call on a CPU tensor runs) against JAX's XLA layers
(``jnp`` backend) and against the Pallas ``wformer_*_tpu`` kernels in
interpret mode; dropout in training; the W-autoencoder's forward with the
posterior noise given; the unfused counterfactual route; the stage-2 losses,
metric state and the per-parameter history clipper.  Inputs, weights and
noise are made with numpy from a seed and handed to both frameworks.

Tolerances: float32 chains 1e-4 relative and absolute; against the Pallas
kernels, which multiply in bf16, the norm-relative acceptance of
tests/test_cvae_interpret.py (rel-L2 1e-2, max 5e-2 of the RMS): the
weights here are drawn at full scale, where the absolute 2e-2 of
tests/test_wformer_interpret.py would depend on the output's size;
losses and clipper statistics 1e-5 relative (the same float32 formulas).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.kernels import api as japi
from pccf_torch.kernels import wformer

from tests.test_torch_port_modules import assert_norm_close, load_port

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-4)
T, D, H, E = 128, 128, 2, 4  # tokens, width, heads (of 64), code embedding width
Z1, Z2, C = 8, 6, 3


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def randomize_params(variables, seed):
    """Every parameter drawn anew: kernels N(0, 1/fan_in), biases N(0, 0.02²),
    LayerNorm scales U(0.8, 1.2), positional tables N(0, 1), so that no
    soft-initialised head hides a difference."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ''
        if name == 'kernel':
            fan = a.shape[0] * (a.shape[1] if a.ndim == 3 and parent == 'out' else 1)
            return (rng.standard_normal(a.shape) / np.sqrt(fan)).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == 'bias':
            return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        return rng.standard_normal(a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(lambda p, a: draw(p, np.asarray(a)), variables['params'])
    return {**{k: v for k, v in variables.items() if k != 'params'}, 'params': params}


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


# ------------------------------------------------------------------ config


def test_stage2_config_matches_composed_yaml():
    """The port's stage-2 dataclasses equal the composed JAX config: dropout
    rates, batch, epochs, AdamW, the history clipper, the cosine schedule
    and the KLD weights."""
    from pccf.config import get_config_all
    from pccf.config.options import Schedulers
    from pccf_torch.config import SliceConfig

    cfg = get_config_all([])
    port = SliceConfig().w_autoencoder
    wae, train = cfg.w_autoencoder.model, cfg.w_autoencoder.train
    for mine, theirs in ((port.w_encoder, wae.w_encoder), (port.w_decoder, wae.w_decoder),
                         (port.conditional_w_encoder, wae.conditional_w_encoder)):
        assert mine.dropout_rates == tuple(theirs.dropout_rates)
    assert port.w_decoder.dropout_rates[:4] == (0.1,) * 4 and set(port.w_encoder.dropout_rates) == {0.0}
    pt, learn = port.train, train.learn
    assert (pt.batch_size, pt.n_epochs) == (train.batch_size, train.n_epochs) == (32, 500)
    assert (pt.learning_rate, pt.grad_op, pt.clip_criterion) == (learn.learning_rate, learn.grad_op,
                                                               learn.clip_criterion)
    assert learn.optimizer_name == 'AdamW' and learn.opt_settings == {'weight_decay': pt.weight_decay}
    sch = learn.scheduler
    assert sch.function == Schedulers.Cosine
    assert (pt.scheduler.restart_interval, pt.scheduler.restart_fraction, pt.scheduler.warmup_steps) == (
        sch.restart_interval, sch.restart_fraction, sch.warmup_steps)
    assert sch.settings == {'min_decay': pt.scheduler.min_decay, 'decay_steps': pt.scheduler.decay_steps}
    assert (pt.c_kld1, pt.c_kld2) == (cfg.w_autoencoder.objective.c_kld1, cfg.w_autoencoder.objective.c_kld2)
    assert not train.early_stopping.active and wae.n_pseudo_inputs == 0
    assert SliceConfig().autoencoder.train.grad_op is cfg.autoencoder.train.learn.grad_op is None


# ------------------------------------------------------------ the stacks

NETS = ['encoder', 'conditional', 'decoder', 'decoder_prior_z1']


def _net_pair(kind, seed):
    """A flax W-net and the port's, with the same random weights, and the
    inputs of both.  The decoder's FF widths differ per layer; its z1 may
    be one row broadcast across the tokens (a prior draw)."""
    from pccf.nn.layers import gelu_exact
    from pccf.nn import w_networks as jw
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact as tgelu

    b = 2
    if kind == 'encoder':
        jnet = jw.TransformerWEncoder(z1_dim=Z1, n_codes=T, proj_dim=D, n_heads=H, mlp_dims=(256, 128),
                                      dropout_rates=(0.0, 0.0), act=gelu_exact)
        port = tw.TransformerWEncoder(E, Z1, T, D, H, (256, 128), tgelu)
        args = (_rand((b, T, E), seed),)
    elif kind == 'conditional':
        jnet = jw.TransformerWConditionalEncoder(z2_dim=Z2, n_codes=T, proj_dim=D, n_heads=H, mlp_dims=(192,),
                                                 dropout_rates=(0.0,), act=gelu_exact)
        port = tw.TransformerWConditionalEncoder(E, C, Z2, T, D, H, (192,), tgelu)
        probs = np.asarray(jax.nn.softmax(_rand((b, C), seed + 1)))
        args = (probs, _rand((b, T, E), seed))
    else:
        jnet = jw.TransformerWDecoder(embedding_dim=E, n_codes=T, proj_dim=D, n_heads=H, mlp_dims=(256, 128),
                                      dropout_rates=(0.0, 0.0), act=gelu_exact)
        port = tw.TransformerWDecoder(E, Z1, Z2, T, D, H, (256, 128), tgelu)
        args = (_rand((b, 1 if kind == 'decoder_prior_z1' else T, Z1), seed), _rand((b, T, Z2), seed + 1))
    v = randomize_params(jnet.init(jax.random.key(seed), *map(jnp.asarray, args)), seed)
    return jnet, v, args, load_port(port, v)


@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
@pytest.mark.parametrize('kind', NETS)
def test_stacks_match_jax(kind, backend, request, monkeypatch):
    """In eval the port's net runs its layer stack through the wformer
    wrapper (here its plain version); JAX runs its XLA layers (jnp) or the
    Pallas stack kernel (interpret mode)."""
    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
    jnet, v, args, port = _net_pair(kind, seed=NETS.index(kind))
    with japi.force_backend(backend):
        want = np.asarray(jnet.apply(v, *map(jnp.asarray, args), train=False))
    calls = _spy(monkeypatch, wformer, 'plain_decoder' if kind.startswith('decoder') else 'plain_encoder')
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args)).numpy()
    assert calls == [(2, T, D)]
    if backend == 'jnp':
        np.testing.assert_allclose(got, want, **FP32)
    else:
        assert_norm_close(got, want)


def test_stack_plain_equals_module_layers():
    """The packed plain stack (what a CPU tensor runs) against the net's own
    layers run one by one, as training and a failed gate run them."""
    _, _, args, port = _net_pair('decoder', seed=5)
    a = tuple(map(torch.from_numpy, args))
    with torch.no_grad():
        stacked = port(*a)
        port.stack_ok = lambda: False
        layered = port(*a)
    np.testing.assert_allclose(stacked.numpy(), layered.numpy(), **FP32)


def test_stack_gate_follows_jax():
    """``wformer_supported``'s shape rule and the eval/GELU conditions of
    ``_fused_stack_ok``."""
    from pccf.kernels.pallas_wformer import wformer_supported
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import default_act, gelu_exact

    for t, d, h in ((256, 512, 8), (128, 128, 2), (96, 128, 2), (128, 96, 2), (128, 128, 3)):
        assert wformer.supported(t, d, h) == wformer_supported(t, d, 1024, 2, h), (t, d, h)
    net = tw.TransformerWEncoder(E, Z1, T, D, H, (128,), gelu_exact).eval()
    assert net.stack_ok()
    assert not net.train().stack_ok()
    assert not tw.TransformerWEncoder(E, Z1, T, D, H, (128,), default_act).eval().stack_ok()


# ---------------------------------------------------------------- dropout


def test_residual_dropout_keeps_one_minus_p_scaled():
    from pccf_torch.nn.layers import dropout

    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4, 256, 256)
    out = dropout(x, 0.1, gen)
    kept = out != 0
    assert torch.unique(out).tolist() == pytest.approx([0.0, 1 / 0.9])
    assert abs(float(kept.float().mean()) - 0.9) < 0.003
    # an independent draw per element: the batch entries' masks differ and
    # do not correlate
    a, b = kept[0].float().flatten(), kept[1].float().flatten()
    assert not torch.equal(a, b)
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.02
    assert torch.equal(dropout(x, 0.0, None), x)
    with pytest.raises(ValueError, match='Generator'):
        dropout(x, 0.1, None)


def test_attention_dropout_is_one_mask_for_batch_and_heads(monkeypatch):
    """flax's ``broadcast_dropout=True``: one (T, T_kv) keep mask scaled by
    1/(1 - p), the same for every batch entry and head."""
    from pccf_torch.kernels import ops
    from pccf_torch.nn.layers import MultiHeadAttention

    scales = []
    real = ops.attention

    def spy(q, k, v, n_heads, weight_scale=None):
        scales.append(weight_scale)
        return real(q, k, v, n_heads, weight_scale)

    monkeypatch.setattr(ops, 'attention', spy)
    attn = MultiHeadAttention(16, 4)
    x, kv = torch.randn(3, 40, 16), torch.randn(3, 24, 16)
    out = attn(x, kv, 0.25, torch.Generator().manual_seed(1))
    (scale,) = scales
    assert scale.shape == (40, 24)
    assert torch.unique(scale).tolist() == pytest.approx([0.0, 1 / 0.75])
    # the same output as the weights times the broadcast mask, by hand
    q, k, v = (attn.query(x), attn.key(kv), attn.value(kv))
    split = lambda a: a.reshape(3, -1, 4, 4).transpose(1, 2)  # noqa: E731
    w = torch.softmax(split(q) / 2.0 @ split(k).transpose(-1, -2), dim=-1) * scale
    want = attn.out((w @ split(v)).transpose(1, 2).reshape(3, 40, 16))
    torch.testing.assert_close(out, want)


@pytest.mark.parametrize('decoder', [False, True])
def test_dropout_only_in_training(decoder):
    """Eval is deterministic and ignores the rate; training with rate 0
    equals eval; training with a rate draws from the generator, repeatably."""
    from pccf_torch.nn import layers as tl

    layer = (tl.TransformerDecoderLayer if decoder else tl.TransformerEncoderLayer)(16, 2, 32, tl.gelu_exact, 0.3)
    tl.init_from_seed(layer, 0)
    x = torch.randn(2, 8, 16)
    args = (x, torch.randn(2, 8, 16)) if decoder else (x,)
    with torch.no_grad():
        layer.eval()
        e1 = layer(*args, torch.Generator().manual_seed(1))
        e2 = layer(*args, torch.Generator().manual_seed(2))
        layer.train()
        t1 = layer(*args, torch.Generator().manual_seed(1))
        t1_again = layer(*args, torch.Generator().manual_seed(1))
        t2 = layer(*args, torch.Generator().manual_seed(2))
        layer.rate = 0.0
        t0 = layer(*args, None)
    assert torch.equal(e1, e2) and torch.equal(t0, e1)
    assert torch.equal(t1, t1_again) and not torch.equal(t1, t2) and not torch.equal(t1, e1)


# ------------------------------------------------------- W-autoencoder


def _wae_pair(seed, enc_proj=D, enc_heads=H):
    from pccf.data.structures import WInputs as JWInputs
    from pccf.models.w_autoencoders import WAutoEncoder
    from pccf.nn.layers import gelu_exact
    from pccf.nn import w_networks as jw
    from pccf_torch.models.w_autoencoders import WAutoEncoder as TWAE
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact as tgelu

    jwae = WAutoEncoder(
        encoder=jw.TransformerWEncoder(z1_dim=Z1, n_codes=T, proj_dim=enc_proj, n_heads=enc_heads,
                                       mlp_dims=(256, 128), dropout_rates=(0.0, 0.0), act=gelu_exact),
        decoder=jw.TransformerWDecoder(embedding_dim=E, n_codes=T, proj_dim=D, n_heads=H, mlp_dims=(128, 256),
                                       dropout_rates=(0.0, 0.0), act=gelu_exact),
        z2_prior=jw.ConditionalPrior(n_codes=T, z2_dim=Z2),
        z2_posterior=jw.TransformerWConditionalEncoder(z2_dim=Z2, n_codes=T, proj_dim=D, n_heads=H, mlp_dims=(192,),
                                                       dropout_rates=(0.0,), act=gelu_exact),
        n_codes=T, embedding_dim=E, book_size=8, z1_dim=Z1, z2_dim=Z2, n_classes=C, conditional=True,
    )
    port = TWAE(
        encoder=tw.TransformerWEncoder(E, Z1, T, enc_proj, enc_heads, (256, 128), tgelu),
        decoder=tw.TransformerWDecoder(E, Z1, Z2, T, D, H, (128, 256), tgelu),
        z2_prior=tw.ConditionalPrior(C, T, Z2),
        z2_posterior=tw.TransformerWConditionalEncoder(E, C, Z2, T, D, H, (192,), tgelu),
        n_codes=T, embedding_dim=E, z1_dim=Z1, z2_dim=Z2, n_classes=C,
    )
    w_q, logits, book = _rand((2, T * E), seed), _rand((2, C), seed + 1, 2.0), _rand((T, 8, E), seed + 2)
    inputs = JWInputs(jnp.asarray(w_q), jnp.asarray(logits))
    v = jwae.init({'params': jax.random.key(seed), 'sampling': jax.random.key(1)}, inputs, jnp.asarray(book))
    v = randomize_params(v, seed)
    return jwae, v, (w_q, logits, book), load_port(port, v)


def fixed_gaussian_sample(monkeypatch, eps):
    """Hand the JAX W-autoencoder the test's standard normal draws, in the
    order it samples (z1, then z2): ``pccf`` keeps its formula, only the draw
    is replaced."""
    from pccf.models.w_autoencoders import WAutoEncoder

    draws = iter(eps)
    monkeypatch.setattr(WAutoEncoder, '_gaussian_sample',
                        lambda self, mu, log_var: jnp.asarray(next(draws)) * jnp.exp(0.5 * log_var) + mu)


FIELDS = ('mu1', 'log_var1', 'probs', 'p_mu2', 'p_log_var2', 'd_mu2', 'd_log_var2', 'z1', 'z2', 'w_recon', 'w_dist_2')


@pytest.mark.parametrize('train', [False, True])
def test_wae_forward_matches_jnp(train, monkeypatch):
    """``__call__`` with the posterior noise given, every Outputs field; in
    eval the port's stacks take the wformer route, in training its layers
    (dropout 0) run one by one, as JAX's XLA layers do."""
    from pccf.data.structures import WInputs as JWInputs
    from pccf_torch.data.structures import WInputs

    jwae, v, (w_q, logits, book), port = _wae_pair(seed=11)
    eps = (_rand((2, T, Z1), 12), _rand((2, T, Z2), 13))
    fixed_gaussian_sample(monkeypatch, eps)
    with japi.force_backend('jnp'):
        want = jwae.apply(v, JWInputs(jnp.asarray(w_q), jnp.asarray(logits)), jnp.asarray(book), train=train,
                          rngs={'sampling': jax.random.key(0), 'dropout': jax.random.key(1)})
    calls = _spy(monkeypatch, wformer, 'plain_encoder')
    port.train(train)
    with torch.no_grad():
        got = port(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)), torch.from_numpy(book),
                   eps=tuple(map(torch.from_numpy, eps)))
    assert len(calls) == (0 if train else 2)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **FP32)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


def test_unfused_counterfactual_matches_jnp(monkeypatch):
    """A W-encoder wider than the decoder (256 wide, 4 heads) fails the fused
    chain's gate on both sides: the nets run one by one, each stack through
    the wformer route."""
    from pccf.data.structures import WInputs as JWInputs
    from pccf_torch.data.structures import WInputs

    jwae, v, (w_q, logits, book), port = _wae_pair(seed=21, enc_proj=256, enc_heads=4)
    assert not port.fused_ok()
    with japi.force_backend('jnp'):
        want = jwae.apply(v, JWInputs(jnp.asarray(w_q), jnp.asarray(logits)), jnp.asarray(book), 1, 0.7,
                          method='generate_counterfactual')
    enc_calls = _spy(monkeypatch, wformer, 'plain_encoder')
    dec_calls = _spy(monkeypatch, wformer, 'plain_decoder')
    with torch.no_grad():
        got = port.eval().generate_counterfactual(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
                                                  torch.from_numpy(book), 1, 0.7)
    assert enc_calls == [(2, T, 256), (2, T, D)] and dec_calls == [(2, T, D)]
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.w_recon.numpy(), np.asarray(want.w_recon), **FP32)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


# ------------------------------------------------------------------ losses


def _loss_case(seed):
    from pccf.data.structures import Outputs as JOutputs, WTargets as JWTargets
    from pccf_torch.data.structures import Outputs, WTargets

    b, t, z, book = 3, 16, 4, 8
    arrays = {
        'mu1': _rand((b, t, z), seed), 'log_var1': _rand((b, t, z), seed + 1, 0.5),
        'p_mu2': _rand((b, t, z), seed + 2), 'p_log_var2': _rand((b, t, z), seed + 3, 0.5),
        'd_mu2': _rand((b, t, z), seed + 4), 'd_log_var2': _rand((b, t, z), seed + 5, 0.5),
        'w_recon': _rand((b, t * 4), seed + 6), 'w_dist_2': np.abs(_rand((b, t, book), seed + 7)),
    }
    idx = np.random.default_rng(seed + 8).integers(0, book, (b, t))
    one_hot = np.eye(book, dtype=np.float32)[idx]
    w_e = _rand((b, t * 4), seed + 9)
    jout = JOutputs(model_epoch=137.0, **{k: jnp.asarray(a) for k, a in arrays.items()})
    tout = Outputs(model_epoch=137.0, **{k: torch.from_numpy(a) for k, a in arrays.items()})
    return (jout, JWTargets(jnp.asarray(w_e), jnp.asarray(one_hot))), (tout, WTargets(torch.from_numpy(w_e),
                                                                                      torch.from_numpy(one_hot)))


@pytest.mark.parametrize('epoch', [0.0, 137.0, 500.0, 650.0])
def test_w_autoencoder_loss_matches_jax(epoch):
    """MSE + annealing · (0.1 KLD1 + 4 KLD2) | quantisation accuracy: every
    term and the loss, with the cosine annealing at and past its ends."""
    from pccf.config import get_config_all
    from pccf.train.losses import get_w_autoencoder_loss as jloss
    from pccf_torch.config import WAutoEncoderTrainConfig
    from pccf_torch.train import get_w_autoencoder_loss

    (jout, jt), (tout, tt) = _loss_case(31)
    jout, tout = jout.replace(model_epoch=epoch), tout.replace(model_epoch=epoch)
    want_loss, want = jloss(get_config_all([])).loss_and_metrics(jout, jt)
    got_loss, got = get_w_autoencoder_loss(WAutoEncoderTrainConfig()).loss_and_metrics(tout, tt)
    assert set(got) == set(want) == {'MSE', 'KLD1', 'KLD2', 'Annealing', 'Quantisation Accuracy', 'Loss'}
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def test_kld_terms_match_jax():
    from pccf.train import losses as jl
    from pccf_torch.train import losses as tl

    (jout, _), (tout, _) = _loss_case(41)
    np.testing.assert_allclose(tl.gaussian_kld(tout.mu1, tout.log_var1).numpy(),
                               np.asarray(jl.gaussian_kld(jout.mu1, jout.log_var1)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.diff_gaussian_kld(tout.d_mu2, tout.d_log_var2, tout.p_log_var2).numpy(),
                               np.asarray(jl.diff_gaussian_kld(jout.d_mu2, jout.d_log_var2, jout.p_log_var2)),
                               rtol=1e-5, atol=1e-7)


def test_metric_state_matches_jax():
    """Batch means folded in with the batch sizes as weights, a metric-only
    objective reports without a loss, and ``Loss * Loss`` multiplies."""
    from pccf.train.objectives import Loss as JLoss, Metric as JMetric
    from pccf_torch.train import Loss, Metric

    values = {name: _rand((5,), seed) for seed, name in enumerate('abm', 51)}

    def calc(name, wrap):
        return lambda outputs, targets: wrap(values[name])

    jobj = (JLoss(calc('a', jnp.asarray), 'a') * JLoss(calc('b', jnp.asarray), 'b')) | JMetric(calc('m', jnp.asarray), 'm')
    tobj = (Loss(calc('a', torch.from_numpy), 'a') * Loss(calc('b', torch.from_numpy), 'b')) | Metric(
        calc('m', torch.from_numpy), 'm')
    want_loss, want = jobj.loss_and_metrics(None, None)
    got_loss, got = tobj.loss_and_metrics(None, None)
    np.testing.assert_allclose(float(got_loss), np.mean(values['a'] * values['b']), rtol=1e-6)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for count in (3, 2):
        jobj.update_state(want, count)
        tobj.update_state(got, count)
        want = {k: 2 * v for k, v in want.items()}
        got = {k: 2 * v for k, v in got.items()}
    assert tobj.compute_metrics().keys() == jobj.compute_metrics().keys() == {'a', 'b', 'm', 'Loss'}
    for name, value in jobj.compute_metrics().items():
        assert tobj.compute_metrics()[name] == pytest.approx(value, rel=1e-6)
    _, only = Metric(calc('m', torch.from_numpy), 'm').loss_and_metrics(None, None)
    assert set(only) == {'m'}
    tobj.reset_state()
    assert tobj.compute_metrics() == {}


# ------------------------------------------------------- history clipper


@pytest.mark.parametrize('criterion', ['EMA', 'ZStat'])
def test_param_hist_clipper_matches_optax(criterion):
    """Four steps of per-parameter clipping with an outlier planted in one
    gradient at step 3: the clipped gradients and the running statistics
    against ``pccf.train.grad_ops.param_hist_clipper``."""
    from pccf.train.grad_ops import param_hist_clipper
    from pccf_torch.train.grad_ops import get_grad_op

    shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 2, 2)}
    params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
    clipper = get_grad_op('ParamHistClipper', params.items(), criterion)
    tx = param_hist_clipper(criterion)
    state = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
    for step in range(4):
        grads = {k: _rand(s, 60 + 10 * step + i) for i, (k, s) in enumerate(shapes.items())}
        if step == 2:
            grads['b'] = grads['b'] * 50.0
        want, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        clipper()
        for k, p in params.items():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7, err_msg=(step, k))
        got_state = clipper.state()
        for k in shapes:
            np.testing.assert_allclose(got_state[k], (float(state.mean[k]), float(state.var[k])), rtol=1e-5,
                                       atol=1e-7, err_msg=(step, k))
        assert clipper.seen == int(state.seen) == step + 1
        if step == 2:  # the outlier was cut to its threshold
            assert np.linalg.norm(params['b'].grad.numpy()) < 0.2 * np.linalg.norm(grads['b'])


def test_grad_op_registry():
    from pccf_torch.train.grad_ops import get_grad_op

    p = torch.nn.Parameter(torch.zeros(2))
    assert get_grad_op(None, [('p', p)]) is None
    for name in ('GradNormClipper', 'HistClipper', 'nonsense'):
        with pytest.raises(ValueError, match='not ported'):
            get_grad_op(name, [('p', p)])

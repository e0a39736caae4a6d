"""The model variants of the experiment tree in pccf_torch against the JAX
package, on the CPU, at small sizes.

The LDGCNN encoder (``encoder=lgcnn``), the non-monotone EdgeConv path (an
encoder activation of GELU), the convolutional W-encoder, the linear
W-decoder, the VampPrior (``n_pseudo_inputs > 0``) with its KLD, the NLL
loss and ``Oracle``; then the paths the card runs at full width, here at
reduced depth: A, the LDGCNN VQ-VAE's counterfactual and one ChamferEMD
stage-1 step; B, one stage-2 step and a counterfactual with the
convolutional W-encoder and the linear W-decoder; C, one stage-2 step and
generation with the VampPrior; D, one stage-1 step with a GELU encoder; E,
a tuning-space corner's counterfactual (heads of 8, 32 and 128, FF widths
137, 1000 and 700, PCGen 500-300-77 with a map of 200, LDGCNN 17-130-511).

Weights are flax initialisations with randomised BatchNorm statistics,
carried across by ``pccf_torch.convert``; inputs come from numpy seeds;
sampling noise and the VampPrior's pseudo-input choices are drawn by the
test and handed to both sides.  Tolerances: forwards, losses and
gradients 1e-4 (float32 on both sides), codes as agreement rates at
``CODE_AGREEMENT`` 0.99 (a near-tie of the VQ argmin may flip), clouds
compared where the codes agree; after a stage-2 step every gradient leaf
rel-L2 1e-4 (leaves whose gradient is zero but for rounding, named in
``_rounding_leaf``, within 1e-5 of the whole gradient's norm on both
sides) and the parameters at 1e-5, but elements whose JAX gradient is at
most ``ROUNDING_GRAD``, whose AdamW move may take either sign: within
2 lr.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs, Targets as JTargets, WInputs as JWInputs, WTargets as JWTargets
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.structures import Inputs, Outputs, Targets, WInputs, WTargets

from tests.test_torch_port_modules import load_port, randomize_stats
from tests.test_torch_port_train import (N_TRAIN, STEPS_PER_EPOCH, _assert_grads_close, _assert_stats_close,
                                         _grads_by_name, _gumbel_patch, _jax_train_step)
from tests.test_torch_port_wformer import fixed_gaussian_sample, randomize_params

torch.set_num_threads(1)

CODE_AGREEMENT = 0.99
FP32 = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# ------------------------------------------------------------------ config


@pytest.mark.parametrize('override', [
    'autoencoder/model/encoder=lgcnn',
    'w_autoencoder/model/w_encoder=convolutional_w_encoder',
    'w_autoencoder/model/w_decoder=linear_w_decoder',
    'w_autoencoder.model.n_pseudo_inputs=3',
])
def test_variant_config_matches_composed_yaml(override):
    """Each variant's fields in the port's dataclasses against
    ``get_config_all`` with the override the JAX tests use."""
    cfg = get_config_all([override])
    port = tc.SliceConfig()
    enc, wae = cfg.autoencoder.model.encoder, cfg.w_autoencoder.model
    if 'encoder=lgcnn' in override:
        mine = dataclasses.replace(port.autoencoder.encoder, class_name='LDGCNN')
        assert (mine.class_name, mine.conv_dims, mine.act_name) == (enc.class_name, tuple(enc.conv_dims), enc.act_name)
        assert enc.n_neighbors == port.data.n_neighbors
    elif 'w_encoder=' in override:
        mine = tc.CONVOLUTIONAL_W_ENCODER
        we = wae.w_encoder
        assert (mine.class_name, mine.conv_dims, mine.dropout_rates, mine.act_name) == (
            we.class_name, tuple(we.conv_dims), tuple(we.dropout_rates), we.act_name)
    elif 'w_decoder=' in override:
        mine = tc.LINEAR_W_DECODER
        wd = wae.w_decoder
        assert (mine.class_name, mine.mlp_dims, mine.dropout_rates, mine.act_name) == (
            wd.class_name, tuple(wd.mlp_dims), tuple(wd.dropout_rates), wd.act_name)
    else:
        assert wae.n_pseudo_inputs == 3 and tc.WAutoEncoderConfig(n_pseudo_inputs=3).n_pseudo_inputs == 3
    flagship = get_config_all([])
    assert flagship.autoencoder.model.encoder.class_name == port.autoencoder.encoder.class_name == 'DGCNN'
    assert tuple(flagship.autoencoder.model.encoder.conv_dims) == port.autoencoder.encoder.conv_dims
    assert flagship.w_autoencoder.model.w_encoder.class_name == port.w_autoencoder.w_encoder.class_name
    assert flagship.w_autoencoder.model.w_decoder.class_name == port.w_autoencoder.w_decoder.class_name
    assert flagship.w_autoencoder.model.n_pseudo_inputs == port.w_autoencoder.n_pseudo_inputs == 0


# ----------------------------------------------------------------- modules


@pytest.mark.parametrize('train', [False, True])
def test_ldgcnn_encoder_matches_jax(train):
    """Forward (eval: running statistics; training: batch statistics, the
    updated running statistics), the input's and every parameter's gradient,
    with pool widths off the kernels' groups of four (6, 10)."""
    from pccf.nn.encoders import LDGCNNEncoder
    from pccf.nn.layers import default_act
    from pccf_torch.nn.encoders import LDGCNNEncoder as TEnc
    from pccf_torch.nn.layers import default_act as tact

    x = _rand((2, 128, 3), 1)
    enc = LDGCNNEncoder(w_dim=32, n_neighbors=6, conv_dims=(6, 10, 12), act=default_act)
    v = randomize_stats(enc.init(jax.random.key(0), jnp.asarray(x)), seed=2)
    cot = _rand((2, 32), 3)

    def jfn(params, a):
        out, upd = enc.apply({'params': params, 'batch_stats': v['batch_stats']}, a, None, train,
                             mutable=['batch_stats'])
        return jnp.sum(out * cot), (out, upd['batch_stats'])

    with japi.force_backend('jnp'):
        (_, (want, stats)), (gp, gx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(v['params'],
                                                                                            jnp.asarray(x))
    port = load_port(TEnc(32, 6, (6, 10, 12), tact), v).train(train)
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    _assert_grads_close(port, _grads_by_name(gp))
    if train:
        _assert_stats_close(port, stats, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('train', [False, True])
def test_non_monotone_edge_conv_matches_jax(train):
    """EdgeConv under GELU: the materialised edge tensor through the
    neighbour gather, BatchNorm, the activation and the first winner; its
    output, the gradients (through the gather's row scatter) and, in
    training, the running statistics."""
    from pccf.kernels import ops as jops
    from pccf.nn.encoders import EdgeConvBlock
    from pccf.nn.layers import gelu_exact
    from pccf_torch.nn.encoders import EdgeConvBlock as TBlock
    from pccf_torch.nn.layers import gelu_exact as tgelu

    x = _rand((2, 128, 8), 4)
    idx = np.asarray(jops.knn(jnp.asarray(x), 6))
    cot = _rand((2, 128, 12), 5)
    blk = EdgeConvBlock(12, 6, gelu_exact, 'GELU')
    v = randomize_stats(blk.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(idx)), seed=6)

    def jfn(params, a):
        out, upd = blk.apply({'params': params, 'batch_stats': v['batch_stats']}, a, jnp.asarray(idx), train,
                             mutable=['batch_stats'])
        return jnp.sum(out * cot), (out, upd['batch_stats'])

    with japi.force_backend('jnp'):
        (_, (want, stats)), (gp, gx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(v['params'],
                                                                                            jnp.asarray(x))
    port = load_port(TBlock(8, 12, 6, tgelu), v).train(train)
    assert not port.monotone
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt, torch.from_numpy(idx))
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    _assert_grads_close(port, _grads_by_name(gp))
    if train:
        _assert_stats_close(port, stats, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('train', [False, True])
def test_convolutional_w_encoder_matches_jax(train):
    from pccf.nn.w_networks import ConvolutionalWEncoder
    from pccf_torch.nn.w_networks import ConvolutionalWEncoder as TEnc

    x = _rand((3, 16, 4), 7)
    enc = ConvolutionalWEncoder(z1_dim=5, conv_dims=(8, 12))
    v = randomize_stats(enc.init(jax.random.key(2), jnp.asarray(x)), seed=8)
    want, _ = enc.apply(v, jnp.asarray(x), train, mutable=['batch_stats'])
    port = load_port(TEnc(4, 5, (8, 12)), v).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (3, 16, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize('one_row', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_linear_w_decoder_matches_jax(one_row, train):
    """Grouped by code, z1 of a row per code or of one row broadcast (the
    unconditional prior's draw); dropout 0 in training."""
    from pccf.nn.layers import default_act
    from pccf.nn.w_networks import LinearWDecoder
    from pccf_torch.nn.layers import default_act as tact
    from pccf_torch.nn.w_networks import LinearWDecoder as TDec

    z1 = _rand((3, 1 if one_row else 16, 4), 9)
    z2 = _rand((3, 16, 5), 10)
    dec = LinearWDecoder(w_dim=64, n_codes=16, mlp_dims=(32, 48), dropout_rates=(0.0, 0.0), act=default_act)
    v = randomize_stats(dec.init(jax.random.key(3), jnp.asarray(z1), jnp.asarray(z2)), seed=11)
    want, _ = dec.apply(v, jnp.asarray(z1), jnp.asarray(z2), train, mutable=['batch_stats'])
    port = load_port(TDec(64, 4, 5, 16, (32, 48), tact, (0.0, 0.0)), v).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(z1), torch.from_numpy(z2))
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_linear_w_decoder_dropout_rates():
    """Each layer's rate after its block, kept elements scaled by 1/(1-rate),
    none in eval."""
    from pccf_torch.nn.layers import default_act, init_from_seed
    from pccf_torch.nn.w_networks import LinearWDecoder

    dec = LinearWDecoder(64, 4, 5, 16, (32, 48, 32), default_act, (0.0, 0.5))
    init_from_seed(dec, 0)
    assert dec.rates == [0.0, 0.5, 0.0]
    z1, z2 = torch.randn(4, 16, 4), torch.randn(4, 16, 5)
    with torch.no_grad():
        a = dec.eval()(z1, z2)
        b = dec.eval()(z1, z2)
        assert torch.equal(a, b)
        c = dec.train()(z1, z2, torch.Generator().manual_seed(0))
        d = dec.train()(z1, z2, torch.Generator().manual_seed(0))
        e = dec.train()(z1, z2, torch.Generator().manual_seed(1))
    assert torch.equal(c, d) and not torch.equal(c, e) and torch.isfinite(c).all()


def test_oracle_returns_an_input_subset():
    from pccf.models.autoencoders import Oracle as JOracle
    from pccf_torch.models import Oracle

    cloud = _rand((2, 64, 3), 12)
    port = Oracle(32, 64)
    assert not list(port.parameters())
    for train in (True, False):
        want = JOracle(32, 64).apply({}, JInputs(cloud=jnp.asarray(cloud)), train=train).recon
        got = port.train(train)(Inputs(torch.from_numpy(cloud))).recon
        assert got.shape == (2, 32 if train else 64, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- VampPrior

W_BASE = [
    'autoencoder.model.w_dim=512',
    'autoencoder.model.book_size=8',
    'w_autoencoder.model.w_encoder.proj_dim=128',
    'w_autoencoder.model.w_encoder.n_heads=2',
    'w_autoencoder.model.w_encoder.mlp_dims=[256]',
    'w_autoencoder.model.w_decoder.proj_dim=128',
    'w_autoencoder.model.w_decoder.n_heads=2',
    'w_autoencoder.model.w_decoder.mlp_dims=[128,256]',
    'w_autoencoder.model.w_decoder.dropout_rates=[0,0,0,0,0]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=128',
    'w_autoencoder.model.conditional_w_encoder.n_heads=2',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[128]',
    'w_autoencoder.model.z1_dim=4',
    'w_autoencoder.model.z2_dim=4',
    'w_autoencoder.train.batch_size=4',
]
B, T, E, BOOK, Z, P = 4, 128, 4, 8, 4, 3
CONV_LINEAR = [
    'w_autoencoder/model/w_encoder=convolutional_w_encoder',
    'w_autoencoder.model.w_encoder.conv_dims=[8,16]',
    'w_autoencoder/model/w_decoder=linear_w_decoder',
    'w_autoencoder.model.w_decoder.mlp_dims=[256,256]',
    'w_autoencoder.model.w_decoder.dropout_rates=[0,0]',
]
VAMP = [f'w_autoencoder.model.n_pseudo_inputs={P}']


def _w_port_config(variant: str) -> tc.SliceConfig:
    net = tc.TransformerNetConfig
    wae = tc.WAutoEncoderConfig(
        z1_dim=Z, z2_dim=Z, w_encoder=net(128, 2, (256,)), w_decoder=net(128, 2, (128, 256)),
        conditional_w_encoder=net(128, 2, (128,)), train=tc.WAutoEncoderTrainConfig(batch_size=B))
    if variant == 'conv_linear':
        wae = dataclasses.replace(
            wae, w_encoder=dataclasses.replace(tc.CONVOLUTIONAL_W_ENCODER, conv_dims=(8, 16)),
            w_decoder=dataclasses.replace(tc.LINEAR_W_DECODER, mlp_dims=(256, 256), dropout_rates=(0.0, 0.0)))
    else:
        wae = dataclasses.replace(wae, n_pseudo_inputs=P)
    return tc.SliceConfig(autoencoder=tc.AutoEncoderConfig(book_size=BOOK, w_dim=T * E), w_autoencoder=wae)


def _w_variant(variant: str, seed: int):
    """The flax stage-2 shell of a variant with random weights and codebook,
    and the port's, loaded from it."""
    from pccf.models.w_autoencoders import WAETrainModule, get_w_autoencoder
    from pccf_torch.models import WAETrainModule as TShell, build_w_autoencoder

    if variant == 'conv_linear':  # the switched groups' yaml have no transformer fields
        base = [ov for ov in W_BASE if not ov.startswith(('w_autoencoder.model.w_encoder.',
                                                          'w_autoencoder.model.w_decoder.'))]
        cfg = get_config_all(base + CONV_LINEAR)
    else:
        cfg = get_config_all(W_BASE + VAMP)
    shell = WAETrainModule(wae=get_w_autoencoder(cfg, conditional=True))
    v = shell.init({'params': jax.random.key(seed), 'sampling': jax.random.key(1)},
                   JWInputs(jnp.zeros((2, T * E)), jnp.zeros((2, 2))), train=False)
    v = randomize_stats(randomize_params(v, seed), seed)
    v['constants'] = {'codebook': _rand((T, BOOK, E), seed + 5)}
    port = TShell(build_w_autoencoder(_w_port_config(variant)), BOOK)
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    return cfg, shell, v, port


def _w_batch(n, seed):
    idx = np.random.default_rng(seed).integers(0, BOOK, (n, T))
    return ((_rand((n, T * E), seed + 3), _rand((n, 2), seed + 2, 2.0)),
            (_rand((n, T * E), seed + 1), np.eye(BOOK, dtype=np.float32)[idx]))


@pytest.mark.parametrize('train', [False, True])
def test_vamp_forward_matches_jax(train, monkeypatch):
    """``encode_z1`` over the inputs and the pseudo-inputs, the pseudo rows
    split off, then the sampled forward with the test's noise: every field."""
    cfg, shell, v, port = _w_variant('vamp', seed=3)
    (w_q, logits), _ = _w_batch(B, 20)
    eps = [_rand((B, T, Z), 30), _rand((B, T, Z), 31)]
    fixed_gaussian_sample(monkeypatch, eps)
    with japi.force_backend('jnp'):
        want = shell.apply(v, JWInputs(jnp.asarray(w_q), jnp.asarray(logits)), train,
                           rngs={'sampling': jax.random.key(0), 'dropout': jax.random.key(1)},
                           mutable=['batch_stats'])[0] if train else \
            shell.apply(v, JWInputs(jnp.asarray(w_q), jnp.asarray(logits)), train, rngs={'sampling': jax.random.key(0)})
    with torch.no_grad():
        got = port.train(train)(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
                                tuple(torch.from_numpy(e) for e in eps), torch.Generator().manual_seed(0))
    assert got.pseudo_mu1.shape == (P, T, Z) and got.mu1.shape == (B, T, Z)
    for name in ('mu1', 'log_var1', 'pseudo_mu1', 'pseudo_log_var1', 'z1', 'z2', 'w_recon'):
        assert _rel_l2(getattr(got, name).numpy(), np.asarray(getattr(want, name))) <= 1e-4, name
    assert (got.idx.numpy() == np.asarray(want.idx)).mean() >= CODE_AGREEMENT


def test_vamp_losses_match_jax():
    """``get_kld_vamp_loss``, the VampPrior branch of ``get_kld_loss`` and
    ``get_nll_loss`` against the JAX objectives on the same outputs."""
    from pccf.data.structures import Outputs as JOutputs
    from pccf.train.losses import get_kld_loss as jkld, get_kld_vamp_loss as jvamp, get_nll_loss as jnll
    from pccf_torch.train.losses import get_kld_loss, get_kld_vamp_loss, get_nll_loss

    cfg = get_config_all(W_BASE + VAMP)
    fields = dict(z1=_rand((B, T, Z), 40), mu1=_rand((B, T, Z), 41), log_var1=_rand((B, T, Z), 42, 0.3),
                  pseudo_mu1=_rand((P, T, Z), 43), pseudo_log_var1=_rand((P, T, Z), 44, 0.3),
                  d_mu2=_rand((B, T, Z), 45), d_log_var2=_rand((B, T, Z), 46, 0.3),
                  p_log_var2=_rand((B, T, Z), 47, 0.3), w_dist_2=np.abs(_rand((B, T, BOOK), 48)) + 1e-3)
    one_hot = np.eye(BOOK, dtype=np.float32)[np.random.default_rng(49).integers(0, BOOK, (B, T))]
    jout = JOutputs(**{k: jnp.asarray(a) for k, a in fields.items()}).replace(model_epoch=100)
    tout = Outputs(**{k: torch.from_numpy(a) for k, a in fields.items()}).replace(model_epoch=100)
    jt = JWTargets(jnp.zeros((B, T * E)), jnp.asarray(one_hot))
    tt = WTargets(torch.zeros((B, T * E)), torch.from_numpy(one_hot))
    wcfg = tc.WAutoEncoderTrainConfig()
    pairs = [(jvamp(cfg), get_kld_vamp_loss(P)), (jkld(cfg), get_kld_loss(wcfg, P)), (jnll(), get_nll_loss())]
    for jobj, tobj in pairs:
        want = jobj.compute_all(jout, jt)
        got = tobj.compute_all(tout, tt)
        assert set(got) == set(want), (set(got), set(want))
        for name, value in want.items():
            np.testing.assert_allclose(np.asarray(got[name]), np.asarray(value), rtol=1e-4, atol=1e-3, err_msg=name)


def test_vamp_prior_sample_matches_jax(monkeypatch):
    """``sample_z1_prior`` of the VampPrior: the chosen pseudo-inputs' z1
    statistics under the test's choice and noise, and generation from it."""
    cfg, shell, v, port = _w_variant('vamp', seed=5)
    which = np.asarray([2, 0, 2, 1])
    eps1, eps2 = _rand((B, T, Z), 50), _rand((B, T, Z), 51)
    probs = np.asarray([[0.3, 0.7], [0.5, 0.5], [1.0, 0.0], [0.2, 0.8]], np.float32)
    monkeypatch.setattr(jax.random, 'randint', lambda *a, **k: jnp.asarray(which))
    fixed_gaussian_sample(monkeypatch, [eps1, eps2])
    book = v['constants']['codebook']
    with japi.force_backend('jnp'):
        want = shell.apply(v, jnp.asarray(book), 0.0, B, jnp.asarray(probs),
                           method=lambda m, *a: m.wae.generate_discrete_latent_space(*a),
                           rngs={'sampling': jax.random.key(0)})
    noise = (torch.from_numpy(eps1), torch.from_numpy(eps2), torch.from_numpy(probs), torch.from_numpy(which))
    with torch.no_grad():
        got = port.wae.eval().generate_discrete_latent_space(port.codebook, 0.0, B, None, noise)
    assert _rel_l2(got.z1.numpy(), np.asarray(want.z1)) <= 1e-4
    assert _rel_l2(got.w_recon.numpy(), np.asarray(want.w_recon)) <= 1e-4
    assert (got.idx.numpy() == np.asarray(want.idx)).mean() >= CODE_AGREEMENT
    drawn = port.wae.sample_noise(5, torch.Generator().manual_seed(0))
    assert len(drawn) == 4 and drawn[0].shape == (5, T, Z) and drawn[3].shape == (5,)
    assert int(drawn[3].min()) >= 0 and int(drawn[3].max()) < P


# ------------------------------------------------------- paths B and C: stage 2


ROUNDING_GRAD = 1e-5  # a gradient element at or below this is rounding (as stage 1's live elements)


def _rounding_leaf(name: str) -> bool:
    """Leaves whose gradient is zero but for rounding: attention key biases
    (adding ``q · b_k`` to every score of a row leaves its softmax as it
    is) and the convolutional W-encoder's BatchNorm shifts before its last
    layer (the next Dense + BatchNorm, with no activation between, takes the
    batch mean off again)."""
    return name.endswith('key.bias') or name.startswith('wae.encoder.conv.0.bn.') and name.endswith('.bias')


def _assert_w_grads_close(port, want: dict[str, np.ndarray]) -> None:
    """Every gradient leaf at rel-L2 1e-4 of JAX's, but the rounding leaves:
    on both sides their norm is within 1e-5 of the whole gradient's."""
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for name, p in port.named_parameters():
        got, scale = p.grad.numpy(), np.linalg.norm(want[name])
        if _rounding_leaf(name):
            assert max(np.linalg.norm(got), scale) <= 1e-5 * total, (name, np.linalg.norm(got), scale, total)
        else:
            err = np.linalg.norm(got - want[name])
            assert err <= 1e-4 * scale + 1e-7, f'{name}: |grad diff| {err:.3e}, |grad| {scale:.3e}'


def _jax_w_grads(shell, v, objective, inputs, targets, eps, monkeypatch):
    """The gradient the JAX Trainer's stage-2 step takes
    (``runners.py:298-318``: train mode, the codebook as a constant, epoch
    1 in the outputs) on the test's posterior noise."""
    fixed_gaussian_sample(monkeypatch, eps)
    extra = {k: x for k, x in v.items() if k != 'params'}

    def loss_fn(params):
        outputs, _ = shell.apply({'params': params, **extra}, inputs, train=True,
                                 rngs={'sampling': jax.random.key(0), 'dropout': jax.random.key(1)},
                                 mutable=['batch_stats'])
        return objective.loss_and_metrics(outputs.replace(model_epoch=jnp.float32(1.0)), targets)[0]

    with japi.force_backend('jnp'):
        return jax.grad(loss_fn)(v['params'])


@pytest.mark.parametrize('variant', ['conv_linear', 'vamp'])
def test_stage2_step_matches_jax(variant, monkeypatch):
    """Path B (the convolutional W-encoder and the linear W-decoder, dropout
    0) and path C (the VampPrior, whose KLD replaces KLD1): one W-autoencoder
    step against the JAX Trainer's: metrics, every parameter's gradient
    (against ``jax.value_and_grad`` of the JAX Trainer's loss on the same
    noise, rel-L2 1e-4 a leaf) and every parameter after it.  AdamW's first
    step moves an element by about ``lr · sign(g)``, so an element whose
    gradient is rounding (the leaves of ``_rounding_leaf``, and elements with
    ``|g| <= ROUNDING_GRAD`` such as the linear W-decoder's first BatchNorm
    shifts, which the next layer's batch statistics cancel where its
    activation does not bend) may move the other way: it is held to moves
    within ``2 lr`` of JAX's, every other element to JAX's value at 1e-5."""
    from pccf.dist import get_mesh
    from pccf.train import ModelEpoch, Trainer as JTrainer, get_learning_schema, get_w_autoencoder_loss as jloss
    from pccf_torch.train import Trainer, get_w_autoencoder_loss

    cfg, shell, v, port = _w_variant(variant, seed=7)
    loader = types.SimpleNamespace(batch_size=B, n_batches=lambda inference=False: 2)
    jtrainer = JTrainer(ModelEpoch(shell, 'wae', variables=v), loader, jloss(cfg),
                        get_learning_schema(cfg.w_autoencoder), mesh=get_mesh(1))
    pcfg = _w_port_config(variant)
    trainer = Trainer(port, get_w_autoencoder_loss(pcfg.w_autoencoder.train, pcfg.w_autoencoder.n_pseudo_inputs),
                      pcfg.w_autoencoder.train, 2, seed=7)
    (w_q, logits), (w_e, one_hot) = _w_batch(B, 60)
    eps = tuple(torch.randn((B, T, Z), generator=trainer.generator) for _ in range(2))
    fixed_gaussian_sample(monkeypatch, [e.numpy() for e in eps])
    with japi.force_backend('jnp'):
        want = jtrainer.run_step(JWInputs(w_q, logits), JWTargets(w_e, one_hot, logits))
    got = trainer.run_step(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
                           WTargets(torch.from_numpy(w_e), torch.from_numpy(one_hot)), noise=eps)
    kld = 'KLD2_VAMP' if variant == 'vamp' else 'KLD1'
    assert set(got) == set(want) == {'MSE', kld, 'KLD2', 'Annealing', 'Quantisation Accuracy', 'Loss'}
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), value, rtol=1e-4, err_msg=name)
    want_grads = _grads_by_name(_jax_w_grads(shell, v, jloss(cfg), JWInputs(w_q, logits),
                                             JWTargets(w_e, one_hot, logits), [e.numpy() for e in eps], monkeypatch))
    _assert_w_grads_close(port, want_grads)
    params = jax.device_get(jtrainer.state.params)
    after = port.state_dict()
    lr = trainer.lr_at(0)
    for name, value in flax_to_state_dict({'params': params}).items():
        a, b, g = after[name].numpy(), value.numpy(), want_grads[name]
        rounding = np.full(g.shape, True) if _rounding_leaf(name) else np.abs(g) <= ROUNDING_GRAD
        np.testing.assert_allclose(a[~rounding], b[~rounding], rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(a[rounding] - b[rounding]).max(initial=0.0) <= 2 * lr, name


def test_conv_linear_counterfactual_matches_jax():
    """Path B's counterfactual: the chain's gate fails (no transformer nets),
    so the nets run one by one, as on the JAX side."""
    cfg, shell, v, port = _w_variant('conv_linear', seed=9)
    assert not port.wae.fused_ok()
    (w_q, logits), _ = _w_batch(B, 70)
    book = v['constants']['codebook']
    with japi.force_backend('jnp'):
        want = shell.apply(v, JWInputs(jnp.asarray(w_q), jnp.asarray(logits)), jnp.asarray(book), 1, 0.7,
                           method=lambda m, *a: m.wae.generate_counterfactual(*a))
    with torch.no_grad():
        got = port.wae.eval().generate_counterfactual(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
                                                      port.codebook, 1, 0.7)
    assert _rel_l2(got.w_recon.numpy(), np.asarray(want.w_recon)) <= 1e-4
    assert (got.idx.numpy() == np.asarray(want.idx)).mean() >= CODE_AGREEMENT


# ---------------------------------------------- paths A and D: stage 1 steps

ENCODERS = {
    'ldgcnn': ['autoencoder/model/encoder=lgcnn', 'autoencoder.model.encoder.conv_dims=[8,12,16]'],
    'gelu': ['autoencoder.model.encoder.act_name=GELU'],
}


def _stage1_port_config(encoder: str) -> tc.SliceConfig:
    from tests.test_torch_port_train import _port_train_config

    pcfg = _port_train_config()
    enc = (dataclasses.replace(pcfg.autoencoder.encoder, class_name='LDGCNN', conv_dims=(8, 12, 16))
           if encoder == 'ldgcnn' else dataclasses.replace(pcfg.autoencoder.encoder, act_name='GELU'))
    return dataclasses.replace(pcfg, autoencoder=dataclasses.replace(pcfg.autoencoder, encoder=enc))


@pytest.mark.parametrize('encoder', ['ldgcnn', 'gelu'])
def test_stage1_step_matches_jax(encoder, monkeypatch):
    """Path A (the LDGCNN encoder, pools at 8 and 12 channels) and path D
    (DGCNN under GELU: three EdgeConvs on the gather path, whose gradient is
    the row scatter): one ChamferEMD step from the same flax weights, batch,
    sampling and Gumbel noise: losses, every gradient, the BatchNorm
    statistics, the parameters after AdamW."""
    from pccf.models import get_autoencoder
    from pccf_torch.models import build_vqvae
    from pccf_torch.train import Trainer, get_autoencoder_loss
    from tests.test_torch_port_train import TRAIN_OVERRIDES

    cfg = get_config_all(TRAIN_OVERRIDES + ENCODERS[encoder])
    rng = np.random.default_rng(23)
    cloud = (rng.standard_normal((2, N_TRAIN, 3)) / 2).astype(np.float32)
    ref = (cloud + rng.standard_normal(cloud.shape) * 0.01).astype(np.float32)
    sampling = rng.standard_normal((2, N_TRAIN, 4)).astype(np.float32)
    uniform = rng.uniform(1e-20, 1.0, (2, N_TRAIN, 2)).astype(np.float32)
    _gumbel_patch(monkeypatch, uniform)
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    v = randomize_stats(init({'params': jax.random.key(2), 'sampling': jax.random.key(3)},
                             JInputs(cloud=jnp.asarray(cloud)), jnp.zeros((2, 2))), seed=23)
    metrics, grads, new_stats, new_params = _jax_train_step(
        cfg, v, JInputs(cloud=jnp.asarray(cloud), initial_sampling=jnp.asarray(sampling)),
        JTargets(ref_cloud=jnp.asarray(ref)))
    pcfg = _stage1_port_config(encoder)
    port = load_port(build_vqvae(pcfg), v)
    trainer = Trainer(port, get_autoencoder_loss(pcfg), pcfg.autoencoder.train, STEPS_PER_EPOCH)
    got = trainer.run_step(Inputs(torch.from_numpy(cloud), initial_sampling=torch.from_numpy(sampling)),
                           Targets(torch.from_numpy(ref)), torch.from_numpy(uniform))
    for name, value in metrics.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=1e-4, err_msg=name)
    want_grads = _grads_by_name(grads)
    _assert_grads_close(port, want_grads)
    _assert_stats_close(port, new_stats, rtol=1e-4, atol=1e-6)
    after = port.state_dict()
    for name, want in flax_to_state_dict({'params': new_params}).items():
        if name.startswith('w_autoencoder.'):
            continue
        live = np.abs(want_grads[name]) > 1e-5
        np.testing.assert_allclose(after[name].numpy()[live], want.numpy()[live], rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------ paths A, B, E: the counterfactual

N_CF = 256
CF_BASE = [
    f'data.n_input_points={N_CF}', f'data.n_target_points={N_CF}', 'data.n_neighbors=8',
    'autoencoder.model.w_dim=512', 'autoencoder.model.book_size=8',
    'w_autoencoder.model.z1_dim=8', 'w_autoencoder.model.z2_dim=6',
]
CORNER = [  # path E at reduced depth: one layer a net, 128 tokens
    'autoencoder/model/encoder=lgcnn', 'autoencoder.model.encoder.conv_dims=[17,130,511]',
    'autoencoder.model.decoder.conv_dims=[500,300,77]', 'autoencoder.model.decoder.map_dims=[200]',
    'autoencoder.model.decoder.sample_dim=32', 'autoencoder.model.decoder.n_components=3',
    'w_autoencoder.model.w_decoder.proj_dim=128', 'w_autoencoder.model.w_decoder.n_heads=16',
    'w_autoencoder.model.w_decoder.mlp_dims=[137]', 'w_autoencoder.model.w_decoder.dropout_rates=[0]',
    'w_autoencoder.model.w_encoder.proj_dim=256', 'w_autoencoder.model.w_encoder.n_heads=8',
    'w_autoencoder.model.w_encoder.mlp_dims=[1000]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=512', 'w_autoencoder.model.conditional_w_encoder.n_heads=4',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[700]',
]
LDGCNN_SMALL = [
    'autoencoder/model/encoder=lgcnn', 'autoencoder.model.encoder.conv_dims=[16,32,64]',
    'autoencoder.model.decoder.map_dims=[8]', 'autoencoder.model.decoder.conv_dims=[512,64,16]',
    'autoencoder.model.decoder.n_components=2', 'autoencoder.model.decoder.sample_dim=4',
    'w_autoencoder.model.w_encoder.proj_dim=128', 'w_autoencoder.model.w_encoder.n_heads=2',
    'w_autoencoder.model.w_encoder.mlp_dims=[128]', 'w_autoencoder.model.w_decoder.proj_dim=128',
    'w_autoencoder.model.w_decoder.n_heads=2', 'w_autoencoder.model.w_decoder.mlp_dims=[128]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=128', 'w_autoencoder.model.conditional_w_encoder.n_heads=2',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[128]',
]


def _cf_port_config(path: str) -> tc.SliceConfig:
    net = tc.TransformerNetConfig
    data = tc.DataConfig(n_input_points=N_CF, n_target_points=N_CF, n_neighbors=8)
    if path == 'E':
        enc = tc.EncoderConfig(class_name='LDGCNN', conv_dims=(17, 130, 511))
        dec = tc.DecoderConfig(sample_dim=32, n_components=3, map_dims=(200,), conv_dims=(500, 300, 77))
        wae = tc.WAutoEncoderConfig(z1_dim=8, z2_dim=6, w_encoder=net(256, 8, (1000,)),
                                    w_decoder=net(128, 16, (137,), dropout_rates=(0.0,)),
                                    conditional_w_encoder=net(512, 4, (700,)))
    else:
        enc = tc.EncoderConfig(class_name='LDGCNN', conv_dims=(16, 32, 64))
        dec = tc.DecoderConfig(sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(512, 64, 16))
        wae = tc.WAutoEncoderConfig(z1_dim=8, z2_dim=6, w_encoder=net(128, 2, (128,)), w_decoder=net(128, 2, (128,)),
                                    conditional_w_encoder=net(128, 2, (128,)))
    return tc.SliceConfig(data=data, autoencoder=tc.AutoEncoderConfig(book_size=8, w_dim=512, encoder=enc,
                                                                      decoder=dec), w_autoencoder=wae)


@pytest.mark.parametrize('path', ['A', 'E'])
def test_counterfactual_matches_jax(path):
    """Path A (the LDGCNN VQ-VAE, the fused chain) and path E (the tuning
    corner: W-nets of different widths, so the chain's gate fails and each
    net's stack runs alone, heads of 8, 32 and 128, FF widths 137, 1000 and
    700; PCGen 500-300-77 on the general kernel's plain version; LDGCNN pools
    at 17 and 130): the counterfactual against JAX's on the jnp path."""
    from pccf.models import get_autoencoder
    from pccf_torch.models import build_vqvae

    cfg = get_config_all(CF_BASE + (CORNER if path == 'E' else LDGCNN_SMALL))
    rng = np.random.default_rng(31)
    clouds = (rng.standard_normal((2, N_CF, 3)) / 2).astype(np.float32)
    sampling = rng.standard_normal((2, N_CF, 32 if path == 'E' else 4)).astype(np.float32)
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    v = randomize_stats(init({'params': jax.random.key(4), 'sampling': jax.random.key(5)},
                             JInputs(cloud=jnp.asarray(clouds)), jnp.zeros((2, 2))), seed=31)
    port = load_port(build_vqvae(_cf_port_config(path)), v)
    assert port.w_autoencoder.fused_ok() == (path == 'A') and port.decoder.fused_ok(N_CF)
    logits = np.asarray([[0.3, -0.2], [-1.0, 0.5]], np.float32)
    with japi.force_backend('jnp'):
        want = jax.jit(lambda v_, *a: jvq.apply(v_, *a, method='generate_counterfactual'))(
            v, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)), jnp.asarray(logits),
            jnp.asarray([1, 0]), jnp.asarray([[1.0], [0.8]], jnp.float32))
    with torch.no_grad():
        got = port.generate_counterfactual(
            Inputs(cloud=torch.from_numpy(clouds), initial_sampling=torch.from_numpy(sampling)),
            torch.from_numpy(logits), torch.tensor([1, 0]), torch.tensor([[1.0], [0.8]]))
    assert _rel_l2(got.w_recon.numpy(), np.asarray(want.w_recon)) <= 1e-4
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(got.recon.numpy()[same], np.asarray(want.recon)[same], **FP32)

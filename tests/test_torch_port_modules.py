"""pccf_torch modules against the JAX package, on the CPU, at small widths.

The JAX module is initialised from a seed (BatchNorm statistics randomised so
the folded affines do work), its variables are converted with
pccf_torch.convert, and the same numpy inputs go through both.  For the
modules that hold a kernel (PCGen decoder, inner CVAE) the port's plain path
is held (a) against the JAX Pallas kernel in interpret mode, with the
norm-relative tolerance of tests/test_cvae_interpret.py (the Pallas kernels
round to bf16), and (b) against the JAX jnp path in float32 at 1e-4.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax

from pccf.kernels import api as japi
from pccf_torch.convert import flax_to_state_dict

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def assert_norm_close(got, want, rel_l2=1e-2, rel_max=5e-2):
    """Norm-relative acceptance for bf16 kernels (tests/test_cvae_interpret.py)."""
    scale = float(np.sqrt(np.mean(np.square(want)))) + 1e-12
    l2 = float(np.linalg.norm(got - want)) / (float(np.linalg.norm(want)) + 1e-12)
    assert l2 <= rel_l2, f'rel L2 {l2:.3e} > {rel_l2}'
    assert float(np.abs(got - want).max()) <= rel_max * scale


def randomize_stats(variables, seed):
    """Non-trivial BatchNorm scale/shift and running statistics."""
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(variables))
    flat_p = flax.traverse_util.flatten_dict(variables['params'])
    for key, val in flat_p.items():
        if ('bn' in key and key[-1] in ('scale', 'bias')) or key[-1] in ('bn_scale', 'bn_bias'):
            flat_p[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    out = {'params': flax.traverse_util.unflatten_dict(flat_p)}
    if 'batch_stats' in variables:
        flat_s = flax.traverse_util.flatten_dict(variables['batch_stats'])
        for key, val in flat_s.items():
            if key[-1] in ('mean', 'bn_mean'):
                flat_s[key] = rng.normal(0, 0.1, val.shape).astype(np.float32)
            else:
                flat_s[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
        out['batch_stats'] = flax.traverse_util.unflatten_dict(flat_s)
    return out


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module.eval()


def t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ----------------------------------------------------------------- config


def test_config_matches_composed_yaml():
    """The port's flagship dataclasses equal the composed JAX config,
    unmodified: graph filtering on, and the stage-1 training settings."""
    from pccf.config import get_config_all
    from pccf.config.options import ReconLosses, Schedulers
    from pccf_torch.config import SliceConfig

    cfg = get_config_all([])
    port = SliceConfig()
    ae, dec, wae = cfg.autoencoder.model, cfg.autoencoder.model.decoder, cfg.w_autoencoder.model
    assert port.data.n_input_points == cfg.data.n_input_points == cfg.autoencoder.n_training_output_points
    assert port.data.n_target_points == cfg.autoencoder.objective.n_inference_output_points
    assert port.data.n_neighbors == ae.encoder.n_neighbors == cfg.data.n_neighbors
    assert port.data.n_classes == cfg.data.dataset.n_classes
    c = cfg.classifier.model
    assert (port.classifier.n_neighbors, port.classifier.conv_dims, port.classifier.feature_dim) == (
        c.n_neighbors, tuple(c.conv_dims), c.feature_dim)
    assert (port.classifier.mlp_dims, port.classifier.act_name) == (tuple(c.mlp_dims), c.act_name)
    pa = port.autoencoder
    assert (pa.book_size, pa.embedding_dim, pa.w_dim, pa.n_codes) == (ae.book_size, ae.embedding_dim, ae.w_dim, ae.n_codes)
    assert pa.encoder.act_name == ae.encoder.act_name
    pd = pa.decoder
    assert (pd.sample_dim, pd.n_components, pd.map_dims, pd.conv_dims) == (
        dec.sample_dim, dec.n_components, tuple(dec.map_dims), tuple(dec.conv_dims))
    assert (pd.tau, pd.act_name, pd.filter) == (dec.tau, dec.act_name, dec.filter) == (5.0, 'ReLU', True)
    pt, train, obj = pa.train, cfg.autoencoder.train, cfg.autoencoder.objective
    assert obj.recon_loss == ReconLosses.ChamferEMD and pt.c_embedding == obj.c_embedding
    assert (pt.batch_size, pt.learning_rate) == (train.batch_size, train.learn.learning_rate)
    assert train.learn.optimizer_name == 'AdamW' and train.learn.opt_settings == {'weight_decay': pt.weight_decay}
    assert train.learn.grad_op is None
    sch = train.learn.scheduler
    assert sch.function == Schedulers.Cosine
    assert (pt.scheduler.restart_interval, pt.scheduler.restart_fraction, pt.scheduler.warmup_steps) == (
        sch.restart_interval, sch.restart_fraction, sch.warmup_steps)
    assert sch.settings == {'min_decay': pt.scheduler.min_decay, 'decay_steps': pt.scheduler.decay_steps}
    pw = port.w_autoencoder
    assert (pw.z1_dim, pw.z2_dim, pw.cf_temperature) == (wae.z1_dim, wae.z2_dim, wae.cf_temperature)
    for mine, theirs in ((pw.w_encoder, wae.w_encoder), (pw.w_decoder, wae.w_decoder),
                         (pw.conditional_w_encoder, wae.conditional_w_encoder)):
        assert (mine.proj_dim, mine.n_heads, mine.mlp_dims, mine.act_name) == (
            theirs.proj_dim, theirs.n_heads, tuple(theirs.mlp_dims), theirs.act_name)
    assert wae.n_pseudo_inputs == 0


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize('groups,batch_norm,residual', [(1, True, False), (1, False, True), (4, True, False)])
def test_dense_block_matches_flax(groups, batch_norm, residual):
    from pccf.nn.layers import DenseBlock, default_act
    from pccf_torch.nn.layers import DenseBlock as TDenseBlock, default_act as tact

    x = np.random.default_rng(groups).standard_normal((2, 5, 16)).astype(np.float32)
    jblk = DenseBlock(24, act=default_act, batch_norm=batch_norm, groups=groups, residual=residual)
    v = randomize_stats(jblk.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    want = np.asarray(jblk.apply(v, jnp.asarray(x)))
    port = load_port(TDenseBlock(16, 24, act=tact, batch_norm=batch_norm, groups=groups, residual=residual), v)
    np.testing.assert_allclose(port(t(x)).detach().numpy(), want, **FP32)


def test_mlp_head_matches_flax():
    from pccf.nn.layers import MLPHead, default_act
    from pccf_torch.nn.layers import MLPHead as TMLPHead, default_act as tact

    x = np.random.default_rng(2).standard_normal((3, 12)).astype(np.float32)
    head = MLPHead(dims=(16, 8), out_features=3, act=default_act)
    v = randomize_stats(head.init(jax.random.key(0), jnp.asarray(x)), seed=2)
    port = load_port(TMLPHead(12, (16, 8), 3, tact), v)
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(head.apply(v, jnp.asarray(x))), **FP32)


@pytest.mark.parametrize('decoder', [False, True])
def test_transformer_layers_match_flax(decoder):
    """Pre-norm layers: LayerNorm eps 1e-6, exact GELU, flax MHA head layout."""
    from pccf.nn.layers import TransformerDecoderLayer, TransformerEncoderLayer, gelu_exact
    from pccf_torch.nn import layers as tl

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 6, 16)).astype(np.float32)
    if decoder:
        layer = TransformerDecoderLayer(16, 4, 32, dropout=0.0, act=gelu_exact)
        args = (jnp.asarray(x), jnp.asarray(mem))
        port = tl.TransformerDecoderLayer(16, 4, 32, tl.gelu_exact)
        targs = (t(x), t(mem))
    else:
        layer = TransformerEncoderLayer(16, 4, 32, dropout=0.0, act=gelu_exact)
        args = (jnp.asarray(x),)
        port = tl.TransformerEncoderLayer(16, 4, 32, tl.gelu_exact)
        targs = (t(x),)
    v = layer.init(jax.random.key(0), *args)
    load_port(port, v)
    assert port.norm_0.eps == 1e-6
    np.testing.assert_allclose(port(*targs).detach().numpy(), np.asarray(layer.apply(v, *args)), **FP32)


# ---------------------------------------------------------- encoder, classifier


def test_dgcnn_encoder_matches_jnp():
    """Block by block on the JAX graph (exact arithmetic parity), then end to
    end, where each side builds its own kNN graph: a neighbour near-tie may
    then flip one max, so the end-to-end check counts agreeing outputs."""
    from pccf.kernels import ops as jops
    from pccf.nn.encoders import DGCNNEncoder
    from pccf.nn.layers import default_act
    from pccf_torch.nn.encoders import DGCNNEncoder as TEnc
    from pccf_torch.nn.layers import default_act as tact

    cloud = np.random.default_rng(4).standard_normal((2, 256, 3)).astype(np.float32) / 2
    enc = DGCNNEncoder(w_dim=32, n_neighbors=8, act=default_act)
    v = randomize_stats(enc.init(jax.random.key(0), jnp.asarray(cloud)), seed=4)
    with japi.force_backend('jnp'):
        want = np.asarray(enc.apply(v, jnp.asarray(cloud)))
        _, inter = enc.apply(v, jnp.asarray(cloud), capture_intermediates=True, mutable=['intermediates'])
    port = load_port(TEnc(32, 8, tact), v)
    x = cloud
    with torch.no_grad():
        for i, block in enumerate(port.edge_conv):
            idx = jops.knn(jnp.asarray(x), 8)
            x_want = np.asarray(inter['intermediates'][f'edge_conv_{i}']['__call__'][0])
            x_got = block(t(x), torch.from_numpy(np.array(idx))).numpy()
            np.testing.assert_allclose(x_got, x_want, **FP32)
            x = x_want
        got = port(t(cloud)).numpy()
    assert got.shape == want.shape == (2, 32)
    assert np.isclose(got, want, **FP32).mean() >= 0.95


def test_dgcnn_classifier_matches_jnp():
    from pccf.data.structures import Inputs as JInputs
    from pccf.nn.classifier import DGCNNClassifier
    from pccf.nn.layers import default_act
    from pccf_torch.data.structures import Inputs
    from pccf_torch.nn.classifier import DGCNNClassifier as TCls
    from pccf_torch.nn.layers import default_act as tact

    cloud = np.random.default_rng(5).standard_normal((2, 256, 3)).astype(np.float32) / 2
    cls = DGCNNClassifier(n_classes=3, n_neighbors=6, conv_dims=(8, 16), feature_dim=32, mlp_dims=(32, 16),
                          dropout_rates=(0.5, 0.5), act=default_act)
    v = randomize_stats(cls.init(jax.random.key(0), JInputs(cloud=jnp.asarray(cloud))), seed=5)
    with japi.force_backend('jnp'):
        want = np.asarray(cls.apply(v, JInputs(cloud=jnp.asarray(cloud))))
    port = load_port(TCls(3, 6, (8, 16), 32, (32, 16), tact), v)
    with torch.no_grad():
        got = port(Inputs(cloud=t(cloud))).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_edge_conv_reuses_prefix_of_wider_indices():
    from pccf_torch.kernels import ops
    from pccf_torch.nn.encoders import EdgeConvBlock
    from pccf_torch.nn.layers import default_act, init_from_seed

    x = t(np.random.default_rng(6).standard_normal((1, 64, 3)))
    blk = EdgeConvBlock(3, 8, 4, default_act)
    init_from_seed(blk, 0)
    with torch.no_grad():
        np.testing.assert_array_equal(blk(x, ops.knn(x, 10)).numpy(), blk(x).numpy())


# --------------------------------------------------------------- PCGen decoder

PCGEN = dict(w_dim=128, sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(128, 64, 16), tau=5.0)


def _pcgen_pair(seed=7, b=2, n=256):
    from pccf.nn.decoders import PCGenDecoder
    from pccf_torch.nn.decoders import PCGenDecoder as TDec
    from pccf_torch.nn.layers import relu

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((b, PCGEN['w_dim'])).astype(np.float32)
    samp = rng.standard_normal((b, n, PCGEN['sample_dim'])).astype(np.float32)
    dec = PCGenDecoder(**PCGEN, act=jax.nn.relu, act_name='ReLU', filtering=False)
    v = jax.jit(lambda rngs, w_, s_: dec.init(rngs, w_, n, s_, train=False))(
        {'params': jax.random.key(0), 'sampling': jax.random.key(1)}, jnp.asarray(w), jnp.asarray(samp))
    v = randomize_stats(v, seed)
    port = load_port(TDec(**PCGEN, act=relu), v)
    assert port.fused_ok()
    with torch.no_grad():
        got = port(t(w), t(samp)).numpy()
    return dec, v, (jnp.asarray(w), jnp.asarray(samp)), got


def _apply_decoder(dec, v, args):
    n = args[1].shape[1]
    return np.asarray(jax.jit(lambda v_, w_, s_: dec.apply(v_, w_, n, s_, train=False))(v, *args))


def test_pcgen_decoder_matches_jnp():
    dec, v, args, got = _pcgen_pair()
    with japi.force_backend('jnp'):
        want = _apply_decoder(dec, v, args)
    assert got.shape == (2, 256, 3)
    np.testing.assert_allclose(got, want, **FP32)


def test_pcgen_decoder_matches_pallas_interpret(interpret_pallas):
    dec, v, args, got = _pcgen_pair(seed=8)
    with japi.force_backend('pallas'):
        want = _apply_decoder(dec, v, args)
    assert_norm_close(got, want)


def test_pcgen_unfused_path_equals_fused_plain():
    """Module-by-module (the path a failed structural gate takes) equals the
    plain pcgen_mix over the folded pack."""
    from pccf_torch.nn.decoders import PCGenDecoder
    from pccf_torch.nn.layers import init_from_seed, relu

    dec = PCGenDecoder(**PCGEN, act=relu).eval()
    init_from_seed(dec, 3)
    rng = np.random.default_rng(9)
    w, samp = t(rng.standard_normal((2, 128))), t(rng.standard_normal((2, 64, 4)))
    with torch.no_grad():
        fused = dec(w, samp)
        dec.fused_ok = lambda: False
        unfused = dec(w, samp)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), **FP32)


# ------------------------------------------------------------- inner CVAE

T_CODES, N_CLASSES = 128, 3


def _wae_pair(seed):
    from pccf.data.structures import WInputs as JWInputs
    from pccf.models.w_autoencoders import WAutoEncoder
    from pccf.nn.layers import gelu_exact
    from pccf.nn.w_networks import (ConditionalPrior, TransformerWConditionalEncoder, TransformerWDecoder,
                                    TransformerWEncoder)
    from pccf_torch.models.w_autoencoders import WAutoEncoder as TWAE
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact as tgelu

    t_, d, z1, z2, e, c = T_CODES, 128, 8, 6, 4, N_CLASSES
    jwae = WAutoEncoder(
        encoder=TransformerWEncoder(z1_dim=z1, n_codes=t_, proj_dim=d, n_heads=2, mlp_dims=(256, 128),
                                    dropout_rates=(0.0, 0.0), act=gelu_exact),
        decoder=TransformerWDecoder(embedding_dim=e, n_codes=t_, proj_dim=d, n_heads=2, mlp_dims=(128,),
                                    dropout_rates=(0.0,), act=gelu_exact),
        z2_prior=ConditionalPrior(n_codes=t_, z2_dim=z2),
        z2_posterior=TransformerWConditionalEncoder(z2_dim=z2, n_codes=t_, proj_dim=d, n_heads=2, mlp_dims=(256,),
                                                    dropout_rates=(0.0,), act=gelu_exact),
        n_codes=t_, embedding_dim=e, book_size=8, z1_dim=z1, z2_dim=z2, n_classes=c, conditional=True,
    )
    rng = np.random.default_rng(seed)
    w_q = rng.standard_normal((2, t_ * e)).astype(np.float32)
    logits = rng.standard_normal((2, c)).astype(np.float32)
    book = rng.standard_normal((t_, 8, e)).astype(np.float32)
    inputs = JWInputs(jnp.asarray(w_q), jnp.asarray(logits))
    v = jax.jit(jwae.init)({'params': jax.random.key(seed), 'sampling': jax.random.key(1)}, inputs, jnp.asarray(book))
    port = TWAE(
        encoder=tw.TransformerWEncoder(e, z1, t_, d, 2, (256, 128), tgelu),
        decoder=tw.TransformerWDecoder(e, z1, z2, t_, d, 2, (128,), tgelu),
        z2_prior=tw.ConditionalPrior(c, t_, z2),
        z2_posterior=tw.TransformerWConditionalEncoder(e, c, z2, t_, d, 2, (256,), tgelu),
        n_codes=t_, embedding_dim=e, z1_dim=z1, z2_dim=z2, n_classes=c,
    )
    load_port(port, v)
    return jwae, v, inputs, jnp.asarray(book), port, (t(w_q), t(logits), t(book))


@pytest.fixture(scope='module')
def wae_pair():
    return _wae_pair(seed=0)


def _jax_cf(jwae, v, inputs, book):
    return jax.jit(lambda v_, i_, b_: jwae.apply(v_, i_, b_, 1, 0.7, method='generate_counterfactual'))(
        v, inputs, book)


def _port_cf(port, tensors, fused=True):
    from pccf_torch.data.structures import WInputs

    w_q, logits, book = tensors
    if not fused:
        port.fused_ok = lambda: False
    with torch.no_grad():
        return port.generate_counterfactual(WInputs(w_q, logits), book, 1, 0.7)


def test_cvae_chain_matches_jnp(wae_pair):
    jwae, v, inputs, book, port, tensors = wae_pair
    with japi.force_backend('jnp'):
        want = _jax_cf(jwae, v, inputs, book)
    got = _port_cf(port, tensors)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.w_recon.numpy(), np.asarray(want.w_recon), **FP32)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


def test_cvae_chain_matches_pallas_interpret(wae_pair, interpret_pallas):
    jwae, v, inputs, book, port, tensors = wae_pair
    with japi.force_backend('pallas'):
        want = _jax_cf(jwae, v, inputs, book)
    got = _port_cf(port, tensors)
    assert_norm_close(got.w_recon.numpy(), np.asarray(want.w_recon))


def test_cvae_unfused_modules_equal_packed_chain(wae_pair):
    """The head folds of the pack change nothing but rounding."""
    *_, port, tensors = wae_pair
    fused = _port_cf(port, tensors)
    unfused = _port_cf(port, tensors, fused=False)
    del port.fused_ok  # back to the class's gate for the other tests
    np.testing.assert_allclose(fused.w_recon.numpy(), unfused.w_recon.numpy(), **FP32)


def test_cvae_gate_rejects_mismatched_proj_dim():
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact

    wae = WAutoEncoder(
        encoder=tw.TransformerWEncoder(4, 8, 64, 128, 2, (64,), gelu_exact),
        decoder=tw.TransformerWDecoder(4, 8, 6, 64, 64, 1, (64,), gelu_exact),
        z2_prior=tw.ConditionalPrior(3, 64, 6),
        z2_posterior=tw.TransformerWConditionalEncoder(4, 3, 6, 64, 128, 2, (64,), gelu_exact),
        n_codes=64, embedding_dim=4, z1_dim=8, z2_dim=6, n_classes=3,
    )
    assert not wae.fused_ok()

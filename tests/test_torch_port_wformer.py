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
from tests.test_torch_port_roofline import _pack, drive_stack, recording  # noqa: F401 (a fixture)

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


def test_3xtf32_split_emulation_matches_fp64():
    """The GEMM kernel's split as the tensor cores see it (``tf32_split``): big
    = the word with its low 13 bits masked, small = the remainder rounded to
    TF32 (so the tensor cores' truncation leaves it as it is).  Both parts are
    TF32, they rebuild each element to 2^-22 relative, and small·big +
    big·small + big·big at K = 1024 agrees with the float64 product to 1e-6
    relative, where the big parts alone miss it by more than 1e-4."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 1024)).astype(np.float32))
    (a_big, a_small), (w_big, w_small) = wformer.tf32_split(a), wformer.tf32_split(w)
    for part in (a_big, a_small, w_big, w_small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    for x, (big, small) in ((a, (a_big, a_small)), (w, (w_big, w_small))):
        assert float(((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -22
    want = a.double() @ w.double().T

    def rel(got):
        return float(torch.linalg.norm(got.double() - want) / torch.linalg.norm(want))

    assert rel(a_small @ w_big.T + a_big @ w_small.T + a_big @ w_big.T) <= 1e-6
    assert rel(a_big @ w_big.T) > 1e-4


@pytest.mark.parametrize('decoder', [False, True])
def test_stacks_issue_grouped_launches_in_order(recording, decoder):
    """``Stacks`` against a recording stand-in for the kernel library: one
    weight split, then 7 launches an encoder layer and 12 a decoder layer, in
    order; the q, k, v projections (and the cross-attention's k, v of the
    memory) one grouped GEMM over the layer's own weights, biases, small parts
    and outputs, which the attention reads; the residual adds in place."""
    b, t, t_mem = 2, 128, 64
    pack = _pack(128, (256, 128), decoder)
    res, memory = drive_stack(pack, decoder, b, t, t_mem)
    names = [name for name, _ in recording.calls]
    layer = ['pccf_layer_norm', 'pccf_gemm', 'pccf_attention', 'pccf_gemm']
    if decoder:
        layer += ['pccf_layer_norm', 'pccf_gemm', 'pccf_gemm', 'pccf_attention', 'pccf_gemm']
    layer += ['pccf_layer_norm', 'pccf_gemm', 'pccf_gemm']
    assert len(layer) == (12 if decoder else 7)
    assert names == ['pccf_tf32_split'] + layer * len(pack)

    _, (srcs, dsts, sizes, count, _) = recording.calls[0]
    weights = wformer.stack_weights(pack)
    assert srcs == [w.data_ptr() for w in weights] and sizes == [w.numel() for w in weights]
    assert count == len(weights)
    assert all((dst - dsts[0]) % 256 == 0 for dst in dsts)
    small = dict(zip(srcs, dsts))
    m, d = b * t, 128
    calls = iter(recording.calls[1:])
    for p in pack:
        def gemm(prefix, names, a_rows, res_ptr=None, gelu=0, src=None):
            name, (a, groups, ops, res_arg, mm, n, k, res_rows, gelu_arg, _) = next(calls)
            wts, smalls, biases, outs = (ops[i * groups: (i + 1) * groups] for i in range(4))
            want = [p[f'w{prefix}{x}'] for x in names]
            assert name == 'pccf_gemm' and groups == len(names) and (mm, n, k) == (a_rows, *want[0].shape)
            assert wts == [w.data_ptr() for w in want] and smalls == [small[w.data_ptr()] for w in want]
            assert biases == [p[f'b{prefix}{x}'].data_ptr() for x in names] and len(set(outs)) == groups
            assert (res_arg, gelu_arg, res_rows) == (res_ptr, gelu, mm)
            if src is not None:
                assert a == src
            return outs

        def attention(q, kv, t_k):
            name, (qp, qs, kp, vp, kvs, _, outs, batch, t_q, tk, heads, hd, _) = next(calls)
            assert name == 'pccf_attention' and (qp, kp, vp) == (q, *kv) and (qs, kvs, outs) == (d, d, d)
            assert (batch, t_q, tk, heads, hd) == (b, t, t_k, 2, 64)

        def norm():
            assert next(calls)[0] == 'pccf_layer_norm'

        norm()
        q, k, v = gemm('', 'qkv', m)
        attention(q, (k, v), t)
        gemm('', 'o', m, res.data_ptr())
        if decoder:
            norm()
            (xq,) = gemm('x', 'q', m)
            xk, xv = gemm('x', 'kv', b * t_mem, src=memory.data_ptr())
            attention(xq, (xk, xv), t_mem)
            gemm('x', 'o', m, res.data_ptr())
        norm()
        (f,) = gemm('', '1', m, gelu=1)
        name, args = next(calls)
        assert name == 'pccf_gemm' and args[0] == f and args[2][3] == args[3] == res.data_ptr()


def test_stacks_split_each_weight_once(recording):
    """``Stacks`` splits a weight's small part the first time a GEMM reads it
    (the new ones of a grouped launch together, in one launch), reuses it
    after, and splits none of the parts it was given."""
    a, out = torch.zeros(64, 64), torch.zeros(64, 64)
    w1, w2, w3 = (torch.full((64, 64), float(i)) for i in (1, 2, 3))
    given = torch.zeros(64, 64)
    stacks = wformer.Stacks(1, 64, 64, torch.device('cpu'), {w3.data_ptr(): given})
    stacks.gemm(a, [w1], [None], [out])
    stacks.gemm(a, [w1], [None], [out])
    stacks.gemm(a, [w1, w2, w3], [None] * 3, [out, torch.zeros(64, 64), torch.zeros(64, 64)])
    splits = [args for name, args in recording.calls if name == 'pccf_tf32_split']
    assert [srcs for srcs, *_ in splits] == [[w1.data_ptr()], [w2.data_ptr()]]
    gemms = [args for name, args in recording.calls if name == 'pccf_gemm']
    assert len(gemms) == 3 and gemms[2][2][3:6] == [stacks.small[w1.data_ptr()].data_ptr(),
                                                   stacks.small[w2.data_ptr()].data_ptr(), given.data_ptr()]


def test_cvae_pack_snapshot_owns_its_stack_weights(recording, monkeypatch):
    """The CVAE chain's operands are a snapshot: the stacks' layers are
    copies, split once with the folds when the snapshot is made, so a live
    weight changed in place changes neither a matrix the chain reads nor its
    small part; a chain call splits nothing and reads the snapshot's
    matrices and small parts."""
    from pccf_torch.kernels import _build, cvae
    from pccf_torch.models.w_autoencoders import WAutoEncoder as TWAE
    from pccf_torch.nn import w_networks as tw
    from pccf_torch.nn.layers import gelu_exact as tgelu

    torch.manual_seed(0)
    wae = TWAE(encoder=tw.TransformerWEncoder(E, Z1, T, D, H, (256, 128), tgelu),
               decoder=tw.TransformerWDecoder(E, Z1, Z2, T, D, H, (128, 256), tgelu),
               z2_prior=tw.ConditionalPrior(C, T, Z2),
               z2_posterior=tw.TransformerWConditionalEncoder(E, C, Z2, T, D, H, (192,), tgelu),
               n_codes=T, embedding_dim=E, z1_dim=Z1, z2_dim=Z2, n_classes=C).eval()
    pack = cvae.pack_cvae_cf(wae)
    w = pack.cuda_operands()
    (split,) = recording.calls
    weights = w['weights']
    assert split[0] == 'pccf_tf32_split' and split[1][0] == [x.data_ptr() for x in weights]
    n_enc, n_dec = len(pack.enc1) + len(pack.enc2), len(pack.dec)
    assert set(w['small']) == {x.data_ptr() for x in weights} and len(weights) == 5 + 6 * n_enc + 10 * n_dec
    live = {v.untyped_storage().data_ptr() for v in wformer.stack_weights(pack.enc1 + pack.enc2 + pack.dec)}
    assert not live & {x.untyped_storage().data_ptr() for x in weights}
    query = wae.encoder.layers[0].attn_0.query.weight
    before = w['enc1'][0]['wq'].clone()
    with torch.no_grad():
        query.add_(1.0)
    assert torch.equal(pack.enc1[0]['wq'], query) and torch.equal(w['enc1'][0]['wq'], before)

    monkeypatch.setattr(_build, 'require', lambda *args, **kwargs: None)
    recording.calls.clear()
    cvae.cvae_cf_cuda(torch.zeros(2, T, E), torch.full((2, C), 1.0 / C), pack)
    names = [name for name, _ in recording.calls]
    assert 'pccf_tf32_split' not in names and names.count('pccf_gemm') == 5 + 4 * n_enc + 7 * n_dec
    small = {x.data_ptr(): w['small'][x.data_ptr()].data_ptr() for x in weights}
    for name, args in recording.calls:
        if name == 'pccf_gemm':
            groups, ops = args[1], args[2]
            assert [small[p] for p in ops[:groups]] == ops[groups: 2 * groups]


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
    """Every name of JAX's registry builds its op; any other raises as
    JAX's ``get_grad_op`` does."""
    from pccf.config.options import GradOp
    from pccf_torch.train.grad_ops import get_grad_op

    p = torch.nn.Parameter(torch.zeros(2))
    assert get_grad_op(None, [('p', p)]) is None
    for name in GradOp:
        assert type(get_grad_op(str(name.value), [('p', p)])).__name__ == name.value
    with pytest.raises(ValueError, match='unknown gradient op'):
        get_grad_op('nonsense', [('p', p)])

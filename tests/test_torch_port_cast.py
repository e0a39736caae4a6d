"""The server's bf16 weight cast (``cast_bf16``) on the CPU, the port against
the JAX package.

The models are ``tests/test_torch_port_slice.py``'s small pair (256 points,
128 code tokens of width 128, graph filtering on), built by JAX from a seed
and converted.  Both servers cast the same weights: JAX rounds every float32
leaf to bfloat16 (``pccf/serve.py:216-220``); the port serves
:func:`pccf_torch.serve.bf16_copy`, float32 arithmetic on the rounded values
with the bf16 rounding of BatchNorm's ``rsqrt(σ² + ε)`` that JAX's compiled
cast keeps.
The decoder sampling of a request is JAX's ``fold_in`` draw, handed to the
port's server; generation's draws are the port's, handed to JAX as
``tests/test_torch_port_generate.py`` hands them.

Tolerances: the serving parity tests' (``CODE_AGREEMENT`` 0.99 of the VQ
codes, ``RECON_REL_L2`` 5e-3 for the clouds of agreeing codes); the
classifier's logits 1e-3 (``CAST_LOGITS``); JAX's own
check of its cast (``tests/test_serve.py:288-311``), f32 against bf16 max
|Δ| < 0.3; the bf16-weight GEMM's plain form against float64 arithmetic on
the widened weights at 1e-6 (float32 rounding of sums of 512 to 1024
products); the widening exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.data.structures import Inputs as JInputs
from pccf.kernels import api as japi
from pccf.train import Model
from pccf_torch.data.structures import Inputs
from pccf_torch.kernels import roofline, wformer
from pccf_torch.serve import CounterfactualServer, bf16_copy, stored_dtypes

from tests.test_torch_port_generate import _patch_jax_draws
from tests.test_torch_port_roofline import _pack, drive_stack, recording  # noqa: F401 (a fixture)
from tests.test_torch_port_slice import N_POINTS, pair  # noqa: F401 (a fixture)

torch.set_num_threads(1)

CODE_AGREEMENT = 0.99
RECON_REL_L2 = 5e-3
JAX_CAST_MAX = 0.3  # tests/test_serve.py:311
# the cast classifier's logits against JAX's compiled cast: where XLA rounds
# an operation on bf16 parameters or fuses it into float32 is its compiler's
# choice; the port rounds where the compiled graph on the CPU rounds
# (BatchNorm's rsqrt), and 2.2e-4 remains at logits of magnitude 5
CAST_LOGITS = 1e-3
SEED = 3


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope='module')
def servers(pair):  # noqa: F811
    """The JAX and port cast servers of the pair, and the port's f32 server."""
    from pccf.serve import CounterfactualServer as JServer

    (jcls, vcls, jvq, vvq), (pcls, pvq), _ = pair
    before = {k: v.clone() for k, v in pvq.state_dict().items()}
    jsrv = JServer(Model(jvq, 'vq', variables=vvq), Model(jcls, 'cls', variables=vcls), buckets=(2,),
                   cast_bf16=True, seed=SEED)
    psrv = CounterfactualServer(pvq, pcls, buckets=(2,), cast_bf16=True, seed=SEED)
    f32 = CounterfactualServer(pvq, pcls, buckets=(2,), seed=SEED)
    return jsrv, psrv, f32, before


def _jax_sampling(seeds, n_out=N_POINTS, sample_dim=4):
    """The JAX server's per-request decoder scaffold (``pccf/serve.py:142-148``)."""
    base = jax.random.key(SEED)
    return torch.from_numpy(np.array(jax.vmap(lambda s: jax.random.normal(jax.random.fold_in(base, s),
                                                                           (n_out, sample_dim)))(seeds)))


def test_cast_copy_stores_bf16_and_leaves_the_caller_f32(pair, servers):  # noqa: F811
    _, (pcls, pvq), _ = pair
    _, psrv, _, before = servers
    assert stored_dtypes(psrv.vqvae) == stored_dtypes(psrv.classifier) == {torch.bfloat16}
    assert stored_dtypes(pvq) == stored_dtypes(pcls) == {torch.float32}
    assert all(torch.equal(before[k], v) for k, v in pvq.state_dict().items())
    # the codebook and the BatchNorm statistics too; modules read them widened, exactly
    stored = psrv.vqvae.parametrizations.codebook.original
    assert stored.dtype == torch.bfloat16 and psrv.vqvae.codebook.dtype == torch.float32
    assert torch.equal(psrv.vqvae.codebook, stored.float())
    assert torch.equal(psrv.vqvae.codebook, pvq.codebook.to(torch.bfloat16).float())
    bn = psrv.vqvae.decoder.components.conv[0].bn
    assert bn.parametrizations.running_var.original.dtype == torch.bfloat16
    assert psrv.vqvae.codebook.device == psrv.device


def test_cast_packs_keep_the_stacks_weights_bf16(servers):
    """The CVAE chain's pack holds the stacks' matrices as the cast stores
    them (no fp32 copy), the LayerNorm parameters and biases fp32; the folds
    are float32 products; PCGen's pack folds in float32."""
    _, psrv, _, _ = servers
    pack = psrv.vqvae.w_autoencoder.packed
    assert pack.bf16
    for layer in pack.enc1 + pack.enc2 + pack.dec:
        for name, v in layer.items():
            assert v.dtype == (torch.bfloat16 if name.startswith('w') else torch.float32), name
    assert {w.dtype for w in wformer.stack_weights(pack.enc1 + pack.enc2 + pack.dec)} == {torch.bfloat16}
    assert pack.aw.dtype == pack.bw.dtype == torch.float32
    wae = psrv.vqvae.w_autoencoder
    query = wae.encoder.layers[0].attn_0.query
    assert pack.enc1[0]['wq'].data_ptr() == query.parametrizations.weight.original.data_ptr()
    assert {t.dtype for t in psrv.vqvae.decoder.packed.tensors()[2]} == {torch.float32}


def test_cast_counterfactuals_match_jax(pair, servers):  # noqa: F811
    """Requests through both servers with JAX's scaffold: the clouds, and the
    codes of the models underneath."""
    jsrv, psrv, _, _ = servers
    _, _, (clouds, _) = pair
    logits = np.asarray([[0.3, -0.2], [-1.0, 0.5]], np.float32)
    seeds = np.asarray([5, 6])
    psrv.initial_sampling = lambda s: _jax_sampling(np.asarray(s))
    want = jsrv.counterfactual(clouds, np.asarray([1, 0]), logits, 1.0, seeds)
    got = psrv.counterfactual(clouds, np.asarray([1, 0]), logits, 1.0, seeds)
    del psrv.initial_sampling
    sampling = _jax_sampling(seeds)
    with japi.force_backend('jnp'):
        jout = jsrv._vq_module.apply(jsrv._vq_vars, JInputs(cloud=jnp.asarray(clouds),
                                                            initial_sampling=jnp.asarray(sampling.numpy())),
                                     jnp.asarray(logits), jnp.asarray([1, 0]), jnp.ones((2, 1)),
                                     method='generate_counterfactual')
    with torch.inference_mode():
        pout = psrv.vqvae.generate_counterfactual(Inputs(cloud=torch.from_numpy(clouds), initial_sampling=sampling),
                                                  torch.from_numpy(logits), torch.tensor([1, 0]), torch.ones((2, 1)))
    idx, jidx = pout.idx.numpy(), np.asarray(jout.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    for i in np.nonzero(same)[0]:
        assert _rel(got[i], want[i]) <= RECON_REL_L2
        assert _rel(pout.recon[i].numpy(), got[i]) == 0.0  # the server's request is the model's output


@pytest.mark.parametrize('probs_given', [False, True])
def test_cast_generation_matches_jax(servers, monkeypatch, probs_given):
    """``generate``'s path from the cast copy: the port's draws handed to JAX's
    cast model (``_sample``'s apply, ``pccf/serve.py:150-160``)."""
    jsrv, psrv, _, _ = servers
    b = 2
    noise, sampling = psrv.generation_draws(b, seed=4, chunk=0)
    probs = np.asarray([[0.9, 0.1], [0.2, 0.8]], np.float32) if probs_given else None
    _patch_jax_draws(monkeypatch, noise, conditional=True)
    with japi.force_backend('jnp'):
        want = jsrv._vq_module.apply(jsrv._vq_vars, b, jnp.asarray(sampling.numpy()), 0.0,
                                     None if probs is None else jnp.asarray(probs), method='generate',
                                     rngs={'sampling': jax.random.key(0)})
    with torch.inference_mode():
        got = psrv.vqvae.generate(b, sampling, 0.0, None if probs is None else torch.from_numpy(probs), noise)
        served = psrv.generate(b, probs=probs, seed=4)
    np.testing.assert_array_equal(served, got.recon.numpy())
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    for i in np.nonzero(same)[0]:
        assert _rel(got.recon[i].numpy(), np.asarray(want.recon)[i]) <= RECON_REL_L2


def test_cast_classify_matches_jax(pair, servers):  # noqa: F811
    """The cast classifier's logits: within ``CAST_LOGITS`` of JAX's cast,
    while the f32 and cast servers differ by more."""
    jsrv, psrv, f32, _ = servers
    _, _, (clouds, _) = pair
    want, got = jsrv.classify(clouds), psrv.classify(clouds)
    np.testing.assert_allclose(got, want, rtol=0, atol=CAST_LOGITS)
    assert np.abs(f32.classify(clouds) - want).max() > CAST_LOGITS


def test_cast_serves_close_to_f32(pair, servers):  # noqa: F811
    """JAX's own check of its cast, on the port: f32 and bf16 servers of one
    model within 0.3 everywhere, and apart (the cast is a lossy mode)."""
    _, psrv, f32, _ = servers
    _, _, (clouds, _) = pair
    logits = f32.classify(clouds)
    a = f32.counterfactual(clouds, 0, logits)
    b = psrv.counterfactual(clouds, 0, logits)
    assert np.isfinite(b).all() and np.abs(a - b).max() < JAX_CAST_MAX
    assert not np.array_equal(a, b)


def test_bf16_copy_refuses_nothing_and_drops_packs(pair):  # noqa: F811
    """A copy of a prepacked model folds again from the rounded values."""
    _, (_, pvq), _ = pair
    pvq.prepack()
    cast = bf16_copy(pvq)
    assert cast.w_autoencoder.packed is None and cast.decoder.packed is None
    assert pvq.w_autoencoder.packed is not None and not pvq.w_autoencoder.packed.bf16


@pytest.mark.parametrize('m,n,k,gelu,res', [(128, 64, 128, False, False), (64, 128, 64, True, False),
                                            (128, 64, 96, False, True)])
def test_bf16_weight_gemm_plain_form(m, n, k, gelu, res):
    """``gemm_plain`` with a bf16 weight: float32 arithmetic on the weight
    widened exactly, against float64; the widening is the bf16 bits in the
    top half of the float32 word."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen)
    w = (torch.randn(n, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen)
    r = torch.randn(m // 2, n, generator=gen) if res else None
    got = wformer.gemm_plain(a, w, bias, r, gelu)
    widened = (w.view(torch.int16).to(torch.int32) << 16).view(torch.float32)
    assert torch.equal(widened, w.float())
    want = a.double() @ widened.double().T + bias.double()
    if gelu:
        want = 0.5 * want * (1 + torch.erf(want / 2 ** 0.5))
    if res:
        want = want + r.double().repeat(2, 1)
    assert float((got.double() - want).norm() / want.norm()) <= 1e-6


@pytest.mark.parametrize('decoder', [False, True])
def test_stacks_launch_the_bf16_instance_for_bf16_weights(recording, decoder):  # noqa: F811
    """``Stacks`` on a pack of bf16 matrices: every GEMM goes to
    ``pccf_gemm_bf16w`` with one weight, bias and output pointer a group, no
    small part is split, the launches counted; the launch work sums to the
    stack's with the weights at two bytes."""
    pack = _pack(64, (128, 64), decoder)
    for p in pack:
        for name in list(p):
            if name.startswith('w'):
                p[name] = p[name].to(torch.bfloat16)
    before = wformer.gemm_bf16w_cuda.launches
    drive_stack(pack, decoder)
    names = [name for name, _ in recording.calls]
    assert 'pccf_gemm' not in names and 'pccf_tf32_split' not in names
    gemms = [args for name, args in recording.calls if name == 'pccf_gemm_bf16w']
    per_layer = 7 if decoder else 4
    assert len(gemms) == per_layer * len(pack) == wformer.gemm_bf16w_cuda.launches - before
    weights = {w.data_ptr() for w in wformer.stack_weights(pack)}
    nbytes = 0
    for _, groups, operands, res, m, n, k, res_rows, _, _ in gemms:
        assert len(operands) == 3 * groups and set(operands[:groups]) <= weights
        nbytes += roofline.gemm_work(m, n, k, groups, all(operands[groups: 2 * groups]), res_rows if res else 0,
                                     weight_bytes=2).bytes
    assert nbytes < sum(roofline.gemm_work(m, n, k, g, True, rr if r else 0).bytes
                        for _, g, _, r, m, n, k, rr, _, _ in gemms)


def test_stacks_refuse_mixed_weight_types(recording):  # noqa: F811
    stacks = wformer.Stacks(1, 64, 64, torch.device('cpu'))
    a = torch.zeros(64, 64)
    ws = [torch.zeros(64, 64), torch.zeros(64, 64, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match='differ in shape or type'):
        stacks.gemm(a, ws, [None, None], [torch.zeros(64, 64)] * 2)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        stacks.gemm(a, [torch.zeros(64, 64, dtype=torch.float16)], [None], [torch.zeros(64, 64)])

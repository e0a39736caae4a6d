"""Generation from the prior, pccf_torch against the JAX package, on the CPU.

The models are ``tests/test_torch_port_slice.py``'s small pair (256 points,
128 code tokens of width 128, graph filtering on) and, for the unconditional
model, ``tests/test_torch_port_evaluation.py``'s plain VQVAE of the same
widths.  The test draws the noise with the port's own samplers (z1's and
z2's standard normal, the class prior's probabilities) and hands it to JAX
by monkeypatching ``WAutoEncoder.sample_z1_prior``, ``sample_prob`` (the
conditional model) and ``_gaussian_sample``; the decoder's initial sampling
is passed to both.  Nothing in ``pccf`` is edited.

Tolerances: z1, z2, the probabilities and the W-decoder's output at 1e-4
(float32 chains); VQ codes as agreement (>= 0.99 of the slots, each side
takes its own argmin); the clouds whose codes all agree at rel-L2 5e-3 and,
point by point, at 1e-4 for >= 99.5% of each cloud's points with none past
1e-2: the decode is a float32 function of the codes and the sampling, but
graph filtering's k = 4 neighbours of a point can swap at a distance
near-tie, which moves that point by ~1e-3 (seen: one point of 256, rel-L2
6e-4 and 1e-3 of its cloud; ``tests/test_torch_port_evaluation.py``).  The class prior in
distribution: rows positive and summing to 1 within 1e-6, the mean of each
coordinate within 0.01 of ``1/C`` over 20000 rows (about eight standard
errors), and a Kolmogorov-Smirnov test of the first coordinate against
Beta(1, C - 1) with p >= 0.01 at a fixed seed.
"""

import dataclasses

import numpy as np
import pytest
import scipy.stats
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.generate import generate_random_samples
from pccf_torch.models import build_vqvae
from pccf_torch.nn.layers import init_from_seed

from tests.test_torch_port_evaluation import _assert_clouds_agree, plain_pair  # noqa: F401
from tests.test_torch_port_slice import N_POINTS, pair, port_config  # noqa: F401

torch.set_num_threads(1)

T, Z1, SAMPLE_DIM = 128, 8, 4  # the pair's code tokens, z1 width and decoder sampling width
CODE_AGREEMENT = 0.99
FP32 = dict(rtol=1e-4, atol=1e-4)
RECON_REL_L2 = 5e-3


def _models(pair, plain_pair, conditional):  # noqa: F811
    if conditional:
        (_, _, jvq, v), (_, pvq), _ = pair
        return jvq, v, pvq
    return plain_pair


def _draws(pvq, b, seed):
    """The port's own draws: (z1's, z2's, the class prior's) and the decoder
    sampling, from one generator."""
    gen = torch.Generator().manual_seed(seed)
    noise = pvq.w_autoencoder.sample_noise(b, gen)
    return noise, torch.randn((b, N_POINTS, SAMPLE_DIM), generator=gen)


def _patch_jax_draws(monkeypatch, noise, conditional):
    """JAX's prior draws replaced by the port's: pccf keeps its formulas."""
    from pccf.models.w_autoencoders import WAutoEncoder

    eps1, eps2, prior_probs = (jnp.asarray(x.numpy()) for x in noise)
    monkeypatch.setattr(WAutoEncoder, 'sample_z1_prior', lambda self, batch_size=1: eps1)
    if conditional:
        monkeypatch.setattr(WAutoEncoder, 'sample_prob', lambda self, batch_size=1: prior_probs)
    monkeypatch.setattr(WAutoEncoder, '_gaussian_sample',
                        lambda self, mu, log_var: eps2 * jnp.exp(0.5 * log_var) + mu)


def _bias(kind, b):
    if kind == 'float':
        return 0.5
    return np.random.default_rng(7).standard_normal((b, T, Z1)).astype(np.float32)


def _probs(given, b):
    return np.asarray([[0.9, 0.1], [0.2, 0.8], [0.0, 1.0]][:b], np.float32) if given else None


def _assert_generation_agrees(got, want):
    for name in ('z1', 'z2', 'probs', 'w_recon'):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **FP32)
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    if got.recon is not None:
        g, w = got.recon.numpy()[same], np.asarray(want.recon)[same]
        assert g.shape[1:] == (N_POINTS, 3) and np.isfinite(g).all()
        assert float(np.linalg.norm(g - w) / np.linalg.norm(w)) <= RECON_REL_L2
        _assert_clouds_agree(g, w)


@pytest.mark.parametrize('probs_given', [False, True])
@pytest.mark.parametrize('bias', ['float', 'array'])
@pytest.mark.parametrize('conditional', [True, False])
def test_vqvae_generate_matches_jax(pair, plain_pair, monkeypatch, conditional, bias, probs_given):  # noqa: F811
    """``VQVAE.generate`` on the same draws: the codes from the priors, then
    ``pcgen_mix`` and graph filtering; z1 has one row (a float bias) or one
    per code (an array bias, as ``generate.py`` passes it)."""
    jvq, v, pvq = _models(pair, plain_pair, conditional)
    b = 3
    noise, sampling = _draws(pvq, b, seed=11)
    z1_bias, probs = _bias(bias, b), _probs(probs_given, b)
    _patch_jax_draws(monkeypatch, noise, conditional)
    with japi.force_backend('jnp'):
        want = jvq.apply(v, b, jnp.asarray(sampling.numpy()), jnp.asarray(z1_bias),
                         None if probs is None else jnp.asarray(probs), method='generate',
                         rngs={'sampling': jax.random.key(0)})
    with torch.no_grad():
        got = pvq.generate(b, sampling, torch.as_tensor(z1_bias), None if probs is None else torch.from_numpy(probs),
                           noise)
    assert got.z1.shape == (b, 1 if bias == 'float' else T, Z1)
    if probs is not None:
        np.testing.assert_array_equal(got.probs.numpy(), probs)
    _assert_generation_agrees(got, want)


@pytest.mark.parametrize('bias', ['float', 'array'])
@pytest.mark.parametrize('conditional', [True, False])
def test_generate_discrete_latent_space_matches_jax(pair, plain_pair, monkeypatch, conditional, bias):  # noqa: F811
    """The inner CVAE alone: prior draws, the conditional prior's z2, the
    W-decoder and the VQ argmin."""
    jvq, v, pvq = _models(pair, plain_pair, conditional)
    b = 2
    noise, _ = _draws(pvq, b, seed=12)
    z1_bias = _bias(bias, b)
    _patch_jax_draws(monkeypatch, noise, conditional)
    with japi.force_backend('jnp'):
        want = jvq.apply(v, method=lambda m: m.w_autoencoder.generate_discrete_latent_space(
            m.codebook, jnp.asarray(z1_bias), b, None), rngs={'sampling': jax.random.key(0)})
    with torch.no_grad():
        got = pvq.w_autoencoder.generate_discrete_latent_space(pvq.codebook, torch.as_tensor(z1_bias), b, None,
                                                               noise)
    _assert_generation_agrees(got.replace(recon=None), want)


def test_generation_draws_from_the_generator_when_no_noise_is_given(pair):  # noqa: F811
    """Without noise and sampling, ``generate`` draws both from the
    generator in the order of ``sample_noise`` and then the sampling: the
    same as handing it those draws."""
    _, (_, pvq), _ = pair
    noise, sampling = _draws(pvq, 2, seed=5)
    with torch.no_grad():
        drawn = pvq.generate(2, generator=torch.Generator().manual_seed(5))
        given = pvq.generate(2, sampling, 0.0, None, noise)
    assert torch.equal(drawn.recon, given.recon) and torch.equal(drawn.idx, given.idx)
    with pytest.raises(ValueError, match='torch.Generator'):
        pvq.generate(2)


@pytest.mark.parametrize('n_classes', [2, 5])
def test_class_prior_is_dirichlet_one(n_classes):
    """``sample_prob``: Dirichlet(1) for the conditional model, in
    distribution (the draws cannot equal JAX's); uniform otherwise."""
    pcfg = port_config()
    pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, n_classes=n_classes))
    wae = build_vqvae(pcfg).w_autoencoder
    p = wae.sample_prob(20000, torch.Generator().manual_seed(0)).double().numpy()
    assert p.shape == (20000, n_classes) and (p > 0).all()
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(p.mean(0), 1.0 / n_classes, atol=0.01)
    assert scipy.stats.kstest(p[:, 0], scipy.stats.beta(1, n_classes - 1).cdf).pvalue >= 0.01
    wae.conditional = False
    u = wae.sample_prob(3, torch.Generator().manual_seed(0))
    assert torch.equal(u, torch.full((3, n_classes), 1.0 / n_classes))


def test_generate_config_matches_composed_yaml():
    cfg = get_config_all([]).user.generate
    port = tc.SliceConfig().user.generate
    assert (port.batch_size, port.bias_dim, port.bias_value) == (cfg.batch_size, cfg.bias_dim, cfg.bias_value)


def _small_vqvae():
    vq = build_vqvae(port_config())
    init_from_seed(vq, 3)
    return vq


def _with_generate(pcfg, **kw):
    return dataclasses.replace(pcfg, user=dataclasses.replace(
        pcfg.user, generate=dataclasses.replace(pcfg.user.generate, **kw)))


def test_generate_random_samples_biases_z1():
    """The entry point: ``batch_size`` clouds on the device asked for, z1
    biased in column ``bias_dim`` of every code row, the draws from a host
    generator seeded by ``seed``; an out-of-range ``bias_dim`` raises."""
    pcfg = _with_generate(port_config(), batch_size=2, bias_dim=3, bias_value=1.5)
    vq = _small_vqvae()
    out = generate_random_samples(pcfg, vq, seed=4, device='cpu')
    assert out.shape == (2, N_POINTS, 3) and np.isfinite(out).all()
    bias = torch.zeros((2, T, Z1))
    bias[:, :, 3] = 1.5
    with torch.no_grad():
        want = vq.generate(2, None, bias, generator=torch.Generator().manual_seed(4)).recon.numpy()
        unbiased = vq.generate(2, generator=torch.Generator().manual_seed(4)).recon.numpy()
    np.testing.assert_array_equal(out, want)
    assert np.abs(out - unbiased).max() > 1e-4
    np.testing.assert_array_equal(generate_random_samples(pcfg, vq, seed=4, device='cpu'), out)
    for bad in (Z1, -1):
        with pytest.raises(ValueError, match='out of range'):
            generate_random_samples(_with_generate(pcfg, bias_dim=bad), vq, device='cpu')
    # with no bias the column is not checked, as in generate.py
    assert generate_random_samples(_with_generate(pcfg, bias_dim=Z1, bias_value=0.0), vq, device='cpu').shape[0] == 2

"""The whole counterfactual slice, port against JAX, on the CPU.

A small CounterfactualVQVAE and classifier (N=256 points, T=128 code tokens
of width 128, PCGen (512, 512, 64, 16) with G=2, graph filtering on) are built by
the JAX package from a seed, converted, and driven with the same numpy
clouds, logits and decoder sampling.  The port's CPU path runs every kernel's
plain version; the JAX side runs its jnp path.

Tolerances: logits 1e-4; VQ code indices agree at >= 0.99 of slots; on the
samples whose codes all agree, ``recon`` matches at 1e-4 (the decode is a
float32 function of the codes and the sampling).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs
from pccf.kernels import api as japi
from pccf.models import get_autoencoder
from pccf.nn import get_classifier
from pccf_torch import config as tc
from pccf_torch.data.structures import Inputs
from pccf_torch.kernels import api
from pccf_torch.models import build_vqvae
from pccf_torch.nn import build_classifier
from pccf_torch.nn.layers import init_from_seed
from pccf_torch.serve import CounterfactualServer

from tests.test_torch_port_modules import load_port, randomize_stats

torch.set_num_threads(1)

N_POINTS = 256
OVERRIDES = [
    f'data.n_input_points={N_POINTS}',
    f'data.n_target_points={N_POINTS}',
    'data.n_neighbors=8',
    'classifier.model.n_neighbors=6',
    'classifier.model.conv_dims=[8,16]',
    'classifier.model.mlp_dims=[32,16]',
    'classifier.model.feature_dim=32',
    'autoencoder.model.w_dim=512',
    'autoencoder.model.book_size=8',
    'autoencoder.model.decoder.map_dims=[8]',
    'autoencoder.model.decoder.conv_dims=[512,64,16]',
    'autoencoder.model.decoder.n_components=2',
    'autoencoder.model.decoder.sample_dim=4',
    'w_autoencoder.model.w_encoder.proj_dim=128',
    'w_autoencoder.model.w_encoder.n_heads=2',
    'w_autoencoder.model.w_encoder.mlp_dims=[256,128]',
    'w_autoencoder.model.w_decoder.proj_dim=128',
    'w_autoencoder.model.w_decoder.n_heads=2',
    'w_autoencoder.model.w_decoder.mlp_dims=[128]',
    'w_autoencoder.model.conditional_w_encoder.proj_dim=128',
    'w_autoencoder.model.conditional_w_encoder.n_heads=2',
    'w_autoencoder.model.conditional_w_encoder.mlp_dims=[256]',
    'w_autoencoder.model.z1_dim=8',
    'w_autoencoder.model.z2_dim=6',
]


def port_config() -> tc.SliceConfig:
    """The same small configuration, in the port's dataclasses."""
    net = tc.TransformerNetConfig
    return tc.SliceConfig(
        data=tc.DataConfig(n_input_points=N_POINTS, n_target_points=N_POINTS, n_neighbors=8, n_classes=2),
        classifier=tc.ClassifierConfig(n_neighbors=6, conv_dims=(8, 16), feature_dim=32, mlp_dims=(32, 16)),
        autoencoder=tc.AutoEncoderConfig(
            book_size=8, embedding_dim=4, w_dim=512,
            decoder=tc.DecoderConfig(sample_dim=4, n_components=2, map_dims=(8,), conv_dims=(512, 64, 16)),
        ),
        w_autoencoder=tc.WAutoEncoderConfig(
            z1_dim=8, z2_dim=6, w_encoder=net(128, 2, (256, 128)), w_decoder=net(128, 2, (128,)),
            conditional_w_encoder=net(128, 2, (256,)),
        ),
    )


@pytest.fixture(scope='module')
def pair():
    cfg = get_config_all(OVERRIDES)
    rng = np.random.default_rng(0)
    clouds = (rng.standard_normal((2, N_POINTS, 3)) / 2).astype(np.float32)
    sampling = rng.standard_normal((2, N_POINTS, 4)).astype(np.float32)

    jcls = get_classifier(cfg)
    vcls = randomize_stats(jax.jit(jcls.init)(jax.random.key(1), JInputs(cloud=jnp.asarray(clouds))), seed=1)
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    vvq = init({'params': jax.random.key(2), 'sampling': jax.random.key(3)},
               JInputs(cloud=jnp.asarray(clouds)), jnp.zeros((2, 2)))
    vvq = randomize_stats(vvq, seed=2)

    pcfg = port_config()
    pcls = load_port(build_classifier(pcfg), vcls)
    pvq = load_port(build_vqvae(pcfg), vvq)
    return (jcls, vcls, jvq, vvq), (pcls, pvq), (clouds, sampling)


def test_classify_matches_jnp(pair):
    (jcls, vcls, *_), (pcls, _), (clouds, _) = pair
    with japi.force_backend('jnp'):
        want = np.asarray(jcls.apply(vcls, JInputs(cloud=jnp.asarray(clouds))))
    with torch.no_grad():
        got = pcls(Inputs(cloud=torch.from_numpy(clouds))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generate_counterfactual_matches_jnp(pair):
    (_, _, jvq, vvq), (_, pvq), (clouds, sampling) = pair
    logits = np.asarray([[0.3, -0.2], [-1.0, 0.5]], np.float32)
    target_dim = np.asarray([1, 0])
    target_value = np.asarray([[1.0], [0.8]], np.float32)
    with japi.force_backend('jnp'):
        want = jax.jit(lambda v, *a: jvq.apply(v, *a, method='generate_counterfactual'))(
            vvq, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)),
            jnp.asarray(logits), jnp.asarray(target_dim), jnp.asarray(target_value),
        )
    assert pvq.w_autoencoder.fused_ok() and pvq.decoder.fused_ok()
    with torch.no_grad():
        got = pvq.generate_counterfactual(
            Inputs(cloud=torch.from_numpy(clouds), initial_sampling=torch.from_numpy(sampling)),
            torch.from_numpy(logits), torch.from_numpy(target_dim), torch.from_numpy(target_value),
        )
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.w_recon.numpy(), np.asarray(want.w_recon), rtol=1e-4, atol=1e-4)
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= 0.99
    same = (idx == jidx).all(axis=1)
    assert same.any()
    assert got.recon.shape == (2, N_POINTS, 3)
    np.testing.assert_allclose(got.recon.numpy()[same], np.asarray(want.recon)[same], rtol=1e-4, atol=1e-4)


def test_server_requests_are_batch_invariant(pair):
    """classify + counterfactual through the server: a request gives the same
    output alone and inside a padded batch, and reruns are identical."""
    _, (pcls, pvq), (clouds, _) = pair
    server = CounterfactualServer(pvq, pcls, buckets=(1, 2, 4))
    three = np.concatenate([clouds, clouds[:1] * 0.9])
    out = server.counterfactual(three, target_dim=[1, 0, 1], sampling_seed=[5, 6, 7])
    assert out.shape == (3, N_POINTS, 3) and np.isfinite(out).all()
    alone = server.counterfactual(three[1:2], target_dim=0, sampling_seed=6)
    np.testing.assert_allclose(alone[0], out[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(server.counterfactual(three, [1, 0, 1], sampling_seed=[5, 6, 7]), out)
    assert server.stats['padded'] == 2  # twice 3 requests in a bucket of 4
    # distinct request seeds give distinct decoder scaffolds
    s = server.initial_sampling(np.asarray([5, 6, 5]))
    assert torch.equal(s[0], s[2]) and not torch.equal(s[0], s[1])
    assert server.classify(three).shape == (3, 2)


def test_counterfactual_on_cpu_launches_no_kernel():
    api.reset_launch_counts()
    pcfg = port_config()
    vq, cls = build_vqvae(pcfg), build_classifier(pcfg)
    init_from_seed(vq, 0)
    init_from_seed(cls, 1)
    clouds = np.random.default_rng(1).standard_normal((1, N_POINTS, 3)).astype(np.float32)
    out = CounterfactualServer(vq, cls, buckets=(1,)).counterfactual(clouds, target_dim=1)
    assert np.isfinite(out).all()
    assert set(api.launch_counts().values()) == {0}


def test_port_imports_no_jax():
    """pccf_torch runs where JAX, flax, pydantic and pyyaml are absent."""
    code = (
        'import sys, pccf_torch, pccf_torch.serve, pccf_torch.generate, pccf_torch.convert, pccf_torch.models, pccf_torch.nn, '
        'pccf_torch.kernels.api, pccf_torch.train, pccf_torch.train.autoencoder, pccf_torch.train.w_autoencoder, '
        'pccf_torch.train.classifier, pccf_torch.evaluate_counterfactuals, pccf_torch.data.clouds, '
        'pccf_torch.data.augmentations, pccf_torch.data.processed, pccf_torch.visualize_counterfactuals, '
        'pccf_torch.utils.visualization, pccf_torch.plot_optimization_decoder, '
        'pccf_torch.plot_optimization_w_decoder; '
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pydantic", "yaml") '
        'or m.startswith("pccf.")); print(bad); sys.exit(1 if bad else 0)'
    )
    env = {**os.environ, 'PYTHONPATH': os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

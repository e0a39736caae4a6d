"""The port's serving artifact against the JAX package's, on the CPU.

The JAX models of ``tests/test_torch_export.py``'s configuration (the slice
configuration of ``tests/test_torch_port_slice.py`` with clouds of 64
points) are initialised from a seed with non-trivial BatchNorm statistics,
converted to the port (``pccf_torch/convert.py``), and both servers export
``classify`` and ``counterfactual`` for the CPU (JAX's ``export_server`` with
its jnp kernels, the port's with the plain versions behind its ops).

- The port artifact's ``classify`` against the JAX artifact's: logits
  within 1e-4, the slice parity test's tolerance.
- The port's exported ``counterfactual`` program, fed the JAX artifact's own
  decoder scaffold (``jax.random.normal(fold_in(key(seed), s))``,
  ``pccf/export.py:137-140``), against the JAX artifact's counterfactual for
  the same seeds: as the slice parity test holds them, the code indices of
  the two models agree on at least 0.99 of the slots, and on the samples
  whose codes all agree the clouds match within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs
from pccf.export import export_server as jax_export_server, load_artifact as jax_load_artifact
from pccf.kernels import api as japi
from pccf.models import get_autoencoder
from pccf.nn import get_classifier
from pccf.serve import CounterfactualServer as JaxServer
from pccf.train import Model
from pccf_torch.data.structures import Inputs
from pccf_torch.export import export_server, load_artifact
from pccf_torch.models import build_vqvae
from pccf_torch.nn import build_classifier
from pccf_torch.serve import CounterfactualServer

from tests.test_torch_export import N_CLASSES, N_IN, config
from tests.test_torch_port_modules import load_port, randomize_stats
from tests.test_torch_port_slice import N_POINTS, OVERRIDES

torch.set_num_threads(1)

JAX_OVERRIDES = [o for o in OVERRIDES if not o.startswith('data.n_input_points')] + [f'data.n_input_points={N_IN}']
SEEDS = np.asarray([3, 11, 4], np.int32)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    cfg = get_config_all(JAX_OVERRIDES)
    clouds = (np.random.default_rng(0).standard_normal((2, N_IN, 3)) / 2).astype(np.float32)
    jcls = get_classifier(cfg)
    vcls = randomize_stats(jax.jit(jcls.init)(jax.random.key(1), JInputs(cloud=jnp.asarray(clouds))), seed=1)
    jvq = get_autoencoder(cfg)
    init = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))
    vvq = randomize_stats(init({'params': jax.random.key(2), 'sampling': jax.random.key(3)},
                               JInputs(cloud=jnp.asarray(clouds)), jnp.zeros((2, N_CLASSES))), seed=2)
    jserver = JaxServer(Model(jvq, name='vq', variables=vvq), Model(jcls, name='cls', variables=vcls), buckets=(4,))
    jpath = tmp_path_factory.mktemp('jax_artifact')
    jax_export_server(jserver, jpath, N_IN, N_CLASSES, platforms=['cpu'], include_generate=False)

    pcls, pvq = load_port(build_classifier(config()), vcls), load_port(build_vqvae(config()), vvq)
    ppath = tmp_path_factory.mktemp('port_artifact')
    export_server(CounterfactualServer(pvq, pcls, buckets=(4,)), ppath, N_IN, N_CLASSES, include_generate=False)
    return (jvq, vvq, jax_load_artifact(jpath, 'cpu')), (pvq, load_artifact(ppath))


def _clouds(n, seed):
    return np.random.default_rng(seed).standard_normal((n, N_IN, 3)).astype(np.float32) / 2


def test_classify_matches_the_jax_artifact(pair):
    (_, _, jart), (_, part) = pair
    clouds = _clouds(3, seed=1)
    np.testing.assert_allclose(part.classify(clouds), jart.classify(clouds), rtol=1e-4, atol=1e-4)


def test_counterfactual_program_fed_jax_sampling_matches_the_jax_artifact(pair):
    (jvq, vvq, jart), (pvq, part) = pair
    n = len(SEEDS)
    clouds = _clouds(n, seed=2)
    logits = jart.classify(clouds).copy()
    tdim, tval = np.asarray([1, 0, 1]), np.asarray([1.0, 0.75, 0.5], np.float32)
    want = jart.counterfactual(clouds, tdim, logits, tval, SEEDS)
    key = jax.random.key(0)  # the server's seed
    sampling = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, int(s)), (N_POINTS, 4)))
                         for s in SEEDS])
    b = 4
    args = [np.pad(a, [(0, b - n)] + [(0, 0)] * (a.ndim - 1))
            for a in (clouds, logits, tdim.astype(np.int64), tval[:, None], sampling)]
    with torch.inference_mode():
        got = part.program('counterfactual', b)(*map(torch.from_numpy, args))[:n].numpy()
        codes = pvq.generate_counterfactual(Inputs(cloud=torch.from_numpy(clouds),
                                                   initial_sampling=torch.from_numpy(sampling)),
                                            torch.from_numpy(logits), torch.from_numpy(tdim),
                                            torch.from_numpy(tval[:, None])).idx.numpy()
    with japi.force_backend('jnp'):
        jcodes = np.asarray(jax.jit(lambda v, *a: jvq.apply(v, *a, method='generate_counterfactual'))(
            vvq, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)), jnp.asarray(logits),
            jnp.asarray(tdim), jnp.asarray(tval[:, None])).idx)
    assert (codes == jcodes).mean() >= 0.99
    same = (codes == jcodes).all(axis=1)
    assert same.any()
    assert got.shape == want.shape == (n, N_POINTS, 3)
    np.testing.assert_allclose(got[same], want[same], rtol=1e-4, atol=1e-4)


def test_the_artifacts_differ_only_in_the_draws(pair):
    """Without JAX's scaffold the port artifact draws its own (a torch
    generator per request): the same request then gives another cloud, of
    the same shape and finite."""
    (_, _, jart), (_, part) = pair
    clouds = _clouds(2, seed=3)
    logits = jart.classify(clouds)
    ours, theirs = part.counterfactual(clouds, 1, logits), jart.counterfactual(clouds, 1, logits)
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    assert not np.allclose(ours, theirs, atol=1e-4)

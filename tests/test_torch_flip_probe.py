"""The port's flip probe (``pccf_torch/tools/flip_probe.py``) against the JAX
tool (``tools/flip_probe.py``), on the CPU.

- ``make_data`` bit-equal to the JAX tool's;
- the micro CVAE's first training step from the JAX model's initial weights,
  converted, with the same batch and the same posterior noise handed to
  both: the loss, MSE, KLD1 and KLD2 within 1e-5 relative (float32 through
  one transformer layer a net; the MSE sums 64 x 64 squared errors);
- the regression case of ``tests/test_flip_probe.py`` in the port, with its
  two asserts: seed 0, a flip rate of at least 0.6 and a final MSE below 60
  (``make_wae``'s weights from the port's initialiser, its noise from the
  port's generator).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf_torch.convert import flax_to_state_dict
from pccf_torch.tools import flip_probe as port
from tools import flip_probe as ref

from tests.test_torch_port_wformer import fixed_gaussian_sample

torch.set_num_threads(1)

TERMS_RTOL = 1e-5


@pytest.mark.parametrize('n_per_class,seed', [(32, 0), (64, 3)])
def test_make_data_is_the_jax_tools(n_per_class, seed):
    for got, want in zip(port.make_data(n_per_class, seed), ref.make_data(n_per_class, seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(port.make_codebook(), np.random.default_rng(1).standard_normal((16, 8, 4)).astype(np.float32))


def test_first_step_terms_match_jax(monkeypatch):
    """The JAX tool's loss function (its ``step``'s ``loss_fn``) and the
    port's :func:`loss_terms` on the first batch of the same schedule."""
    from pccf.data.structures import WInputs as JWInputs
    from pccf.train.losses import diff_gaussian_kld, gaussian_kld

    seed, beta_z1, beta_z2 = 0, 2.0, 4.0
    w, logits, _, _ = ref.make_data(32, seed)
    w_flat = w.reshape(w.shape[0], -1)
    steps, anneal = port.schedule(w_flat.shape[0], 10, seed, 0.4)
    rows = steps[0]
    w_b, lg_b, book = w_flat[rows], logits[rows], port.make_codebook()
    # a mid-ramp anneal as well as the first step's 0, so that the KLD terms weigh in
    anneals = (float(anneal[0]), 0.5)

    jwae = ref.make_wae()
    variables = jwae.init({'params': jax.random.key(seed), 'sampling': jax.random.key(seed + 1)},
                          JWInputs(jnp.asarray(w_b[:2]), jnp.asarray(lg_b[:2])), jnp.asarray(book), train=False)
    wae = port.make_wae()
    wae.load_state_dict(flax_to_state_dict(variables), strict=True)
    wae.train()
    eps = [np.random.default_rng(9).standard_normal((len(rows), 16, 4)).astype(np.float32) for _ in range(2)]

    for a in anneals:
        fixed_gaussian_sample(monkeypatch, eps)
        out = jwae.apply(variables, JWInputs(jnp.asarray(w_b), jnp.asarray(lg_b)), jnp.asarray(book), train=True,
                         rngs={'sampling': jax.random.key(1)})
        mse = jnp.sum((out.w_recon - jnp.asarray(w_b).reshape(out.w_recon.shape)) ** 2, axis=1).mean()
        kld1 = jnp.sum(gaussian_kld(out.mu1, out.log_var1), axis=(1, 2)).mean()
        kld2 = jnp.sum(diff_gaussian_kld(out.d_mu2, out.d_log_var2, out.p_log_var2), axis=(1, 2)).mean()
        want = [float(mse + a * (beta_z1 * kld1 + beta_z2 * kld2)), float(mse), float(kld1), float(kld2)]
        with torch.no_grad():
            got = port.loss_terms(wae, torch.from_numpy(book), torch.from_numpy(w_b), torch.from_numpy(lg_b), a,
                                  beta_z1, beta_z2, eps=tuple(map(torch.from_numpy, eps)))
        np.testing.assert_allclose([float(t) for t in got], want, rtol=TERMS_RTOL)


def test_counterfactuals_flip_above_chance():
    """``tests/test_flip_probe.py``'s regression case, in the port."""
    result = port.run(epochs=200, beta_z1=2.0, beta_z2=4.0, lr=5e-3, n_per_class=32, anneal_frac=0.4, seed=0,
                      quiet=True, device='cpu')
    assert result['flip_rate'] >= 0.6, result
    # reconstruction must stay meaningful while flips happen (a decoder that
    # ignores w could "flip" by emitting the prior mean)
    assert result['final_mse'] < 60.0, result
    assert set(result) == {'flip_rate', 'chance', 'per_target', 'final_mse', 'final_kld1', 'final_kld2', 'epochs',
                           'beta_z1', 'beta_z2'}

"""The stage-2 slice of pccf_torch against the JAX package, on the CPU.

The derived latent-code dataset from one flax VQ-VAE and classifier loaded
into both packages; three consecutive W-autoencoder training steps against
``pccf.train.Trainer.run_step`` (dropout 0, the posterior noise drawn by the
port and handed to JAX); the validation ``Test`` pass; the training shell
built from a VQ-VAE and merged back; and the whole entry point at a tiny
size.  Inputs are made with numpy from a seed.

Tolerances: logits and encodings 1e-4 (float32 chains; encodings at >= 0.99
of elements, as each side builds its own kNN graphs); losses and metrics
1e-4 relative; parameters after each step rel-L2 1e-4 per tensor (AdamW's
first steps move an element by about ``lr · sign(g)``, so a gradient element
within rounding of zero may move the other way: the attention key biases,
whose gradient is zero but for rounding, are held to moves of at most
``2 · lr`` a step); clipper statistics 1e-4
relative (norms of gradients that agree to 1e-5 or better).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.structures import WInputs, WTargets

from tests.test_torch_port_modules import load_port
from tests.test_torch_port_slice import pair  # noqa: F401  (the flax VQ-VAE and classifier, and the port's)
from tests.test_torch_port_wformer import fixed_gaussian_sample, randomize_params

torch.set_num_threads(1)

W_OVERRIDES = [
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
B, T, E, BOOK, Z = 4, 128, 4, 8, 4
STEPS_PER_EPOCH = 2  # the third step is in epoch 1: the warmup raises the lr


def w_port_config() -> tc.SliceConfig:
    net = tc.TransformerNetConfig
    return tc.SliceConfig(
        autoencoder=tc.AutoEncoderConfig(book_size=BOOK, w_dim=T * E),
        w_autoencoder=tc.WAutoEncoderConfig(
            z1_dim=Z, z2_dim=Z, w_encoder=net(128, 2, (256,)), w_decoder=net(128, 2, (128, 256)),
            conditional_w_encoder=net(128, 2, (128,)), train=tc.WAutoEncoderTrainConfig(batch_size=B)),
    )


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _w_batch(n, seed):
    """``(WInputs, WTargets)`` as numpy arrays: encodings, logits, and the
    targets' quantised embeddings with their one-hot selections."""
    idx = np.random.default_rng(seed).integers(0, BOOK, (n, T))
    w_e = _rand((n, T * E), seed + 1)
    logits = _rand((n, 2), seed + 2, 2.0)
    return (_rand((n, T * E), seed + 3), logits), (w_e, np.eye(BOOK, dtype=np.float32)[idx], logits)


def _jax_shell(cfg, seed):
    """The flax stage-2 shell with random weights and codebook."""
    from pccf.data.structures import WInputs as JWInputs
    from pccf.models.w_autoencoders import WAETrainModule, get_w_autoencoder

    shell = WAETrainModule(wae=get_w_autoencoder(cfg, conditional=True))
    v = shell.init({'params': jax.random.key(seed), 'sampling': jax.random.key(1)},
                   JWInputs(jnp.zeros((1, T * E)), jnp.zeros((1, 2))), train=False)
    v = randomize_params(v, seed)
    v['constants'] = {'codebook': _rand((T, BOOK, E), seed + 5)}
    return shell, v


def _port_shell(v):
    from pccf_torch.models import WAETrainModule, build_w_autoencoder

    model = WAETrainModule(build_w_autoencoder(w_port_config()), BOOK)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return model


def _per_param(tree_of_scalars, params):
    """A per-leaf scalar tree (the clipper's statistics) keyed by the port's
    parameter names: broadcast to each leaf's shape, converted, read back."""
    full = jax.tree.map(lambda p, s: np.full(np.shape(p), float(s), np.float32), params, tree_of_scalars)
    return {k: float(v.flatten()[0]) for k, v in flax_to_state_dict({'params': full}).items()}


def _zero_gradient(name: str) -> bool:
    """Attention key biases: adding ``q · b_k`` to every score of a row
    leaves its softmax unchanged, so their gradient is zero but for rounding,
    and its sign (AdamW's direction) is noise on both sides."""
    return name.endswith('key.bias')


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_three_training_steps_match_jax(monkeypatch):
    """Three consecutive steps of the W-autoencoder (MSE + annealed KLD,
    ParamHistClipper(EMA), AdamW at 0.0014 with decay 0.001, warmup 6 over
    epochs of 2 steps) against the JAX Trainer's jitted step: metrics,
    every parameter after every step, and the clipper's statistics."""
    from pccf.data.structures import WInputs as JWInputs, WTargets as JWTargets
    from pccf.dist import get_mesh
    from pccf.train import ModelEpoch, Trainer as JTrainer, get_learning_schema, get_w_autoencoder_loss as jloss
    from pccf_torch.train import Trainer, get_w_autoencoder_loss

    cfg = get_config_all(W_OVERRIDES)
    shell, v = _jax_shell(cfg, seed=3)
    loader = types.SimpleNamespace(batch_size=B, n_batches=lambda inference=False: STEPS_PER_EPOCH)
    jtrainer = JTrainer(ModelEpoch(shell, 'wae', variables=v), loader, jloss(cfg),
                        get_learning_schema(cfg.w_autoencoder), mesh=get_mesh(1))
    port = _port_shell(v)
    pcfg = w_port_config().w_autoencoder.train
    trainer = Trainer(port, get_w_autoencoder_loss(pcfg), pcfg, STEPS_PER_EPOCH, seed=7)
    assert trainer.grad_op is not None and trainer.lr_at(2) > trainer.lr_at(0)

    lr_sum = 0.0
    for step in range(3):
        (w_q, logits), (w_e, one_hot, _) = _w_batch(B, 100 + 10 * step)
        eps = tuple(torch.randn((B, T, Z), generator=trainer.generator) for _ in range(2))
        fixed_gaussian_sample(monkeypatch, [e.numpy() for e in eps])
        jtrainer._train_fn = None  # retrace: the noise enters the traced step as a constant
        with japi.force_backend('jnp'):
            want = jtrainer.run_step(JWInputs(w_q, logits), JWTargets(w_e, one_hot, logits))
        got = trainer.run_step(WInputs(torch.from_numpy(w_q), torch.from_numpy(logits)),
                               WTargets(torch.from_numpy(w_e), torch.from_numpy(one_hot)), noise=eps)
        assert set(got) == set(want) == {'MSE', 'KLD1', 'KLD2', 'Annealing', 'Quantisation Accuracy', 'Loss'}
        for name, value in want.items():
            np.testing.assert_allclose(float(got[name]), value, rtol=1e-4, err_msg=(step, name))

        lr_sum += trainer.lr_at(step)
        params = jax.device_get(jtrainer.state.params)
        after = port.state_dict()
        for name, value in flax_to_state_dict({'params': params}).items():
            if _zero_gradient(name):
                assert np.abs(after[name].numpy() - value.numpy()).max() <= 2 * lr_sum, (step, name)
            else:
                assert _rel_l2(after[name].numpy(), value.numpy()) <= 1e-4, (step, name)
        hist = jtrainer.state.opt_state[0]
        mean, var = _per_param(hist.mean, params), _per_param(hist.var, params)
        state = trainer.grad_op.state()
        assert set(state) == set(mean) and trainer.grad_op.seen == int(hist.seen) == step + 1
        scale = max(mean.values())
        for name, (m, s) in state.items():
            if _zero_gradient(name):  # norms of rounding noise on both sides
                assert max(m, mean[name]) <= 1e-5 * scale, (step, name)
                continue
            np.testing.assert_allclose(m, mean[name], rtol=1e-4, err_msg=(step, name))
            np.testing.assert_allclose(s, var[name], rtol=1e-4, atol=1e-10 + 1e-6 * mean[name] ** 2,
                                       err_msg=(step, name))
    assert torch.equal(port.codebook, torch.from_numpy(v['constants']['codebook']))


class _Items:
    """A derived dataset held in memory, for the port's loader."""

    def __init__(self, inputs, targets):
        self.inputs, self.targets = inputs, targets

    def __len__(self):
        return self.inputs[0].shape[0]

    def __getitems__(self, idx):
        (w_q, logits), (w_e, one_hot, lg) = self.inputs, self.targets
        return (WInputs(torch.from_numpy(w_q[idx]), torch.from_numpy(logits[idx])),
                WTargets(torch.from_numpy(w_e[idx]), torch.from_numpy(one_hot[idx]), torch.from_numpy(lg[idx])))


def test_validation_pass_matches_jax(monkeypatch):
    """The eval pass over 5 samples in batches of 3 and 2 (the trailing
    partial batch kept, metrics weighted by batch size), the annealing at
    the model's epoch; the port's stacks take the wformer route.  The
    posterior noise is zero on both sides (JAX draws its own per batch)."""
    from pccf.data.structures import WInputs as JWInputs, WTargets as JWTargets
    from pccf.train import DataLoader, ModelEpoch, Test as JTest, get_w_autoencoder_loss as jloss
    from pccf_torch.kernels import wformer
    from pccf_torch.models.w_autoencoders import WAutoEncoder
    from pccf_torch.train import Loader, Test, get_w_autoencoder_loss

    cfg = get_config_all(W_OVERRIDES)
    shell, v = _jax_shell(cfg, seed=4)
    inputs, targets = _w_batch(5, 200)
    items = [(JWInputs(inputs[0][i], inputs[1][i]), JWTargets(*(a[i] for a in targets))) for i in range(5)]
    jmodel = ModelEpoch(shell, 'wae', variables=v)
    jmodel.epoch = 250
    from pccf.models.w_autoencoders import WAutoEncoder as JWAE

    monkeypatch.setattr(JWAE, '_gaussian_sample', lambda self, mu, log_var: mu)
    with japi.force_backend('jnp'):
        want = JTest(jmodel, DataLoader(items, 3), metric=jloss(cfg), name='TestEncoding')()

    real = WAutoEncoder.sample_posterior
    monkeypatch.setattr(WAutoEncoder, 'sample_posterior', lambda self, data, eps=None, generator=None: real(
        self, data, (torch.zeros_like(data.mu1), torch.zeros_like(data.d_mu2))))
    stacks = []
    real_stack = wformer.plain_encoder
    monkeypatch.setattr(wformer, 'plain_encoder', lambda *a: stacks.append(1) or real_stack(*a))
    port = _port_shell(v)
    pcfg = w_port_config().w_autoencoder.train
    got = Test(port, Loader(_Items(inputs, targets), 3), get_w_autoencoder_loss(pcfg))(epoch=250)
    assert len(stacks) == 4  # W-encoder and posterior, two batches
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-4), name


def test_derived_dataset_matches_jax(pair, monkeypatch):  # noqa: F811
    """Encodings, quantised embeddings, one-hot selections and logits of the
    frozen models, chunked at 2 clouds, against
    ``pccf.data.processed.WDatasetWithLogits``."""
    from pccf.data.processed import WDatasetWithLogits as JDataset
    from pccf.data.structures import Inputs as JInputs, Targets as JTargets
    from pccf.train.model import Model
    from pccf_torch.data import processed

    (jcls, vcls, jvq, vvq), (pcls, pvq), _ = pair
    clouds = (np.random.default_rng(5).standard_normal((5, 256, 3)) / 2).astype(np.float32)
    backing = [(JInputs(cloud=c), JTargets(ref_cloud=c, label=np.int64(0))) for c in clouds]
    monkeypatch.setattr(JDataset, 'max_batch', 2)
    monkeypatch.setattr(processed, 'MAX_BATCH', 2)
    with japi.force_backend('jnp'):
        items = JDataset(backing, Model(jvq, 'vq', variables=vvq), Model(jcls, 'cls', variables=vcls)).__getitems__(
            [4, 0, 2, 1, 3])
    got_in, got_t = processed.WDatasetWithLogits(torch.from_numpy(clouds), pvq, pcls).__getitems__([4, 0, 2, 1, 3])
    want = {name: np.stack([getattr(part, name) for _, part in items]) for name in ('w_e', 'one_hot_idx', 'logits')}
    want_w_q = np.stack([inp.w_q for inp, _ in items])
    np.testing.assert_allclose(got_in.logits.numpy(), want['logits'], rtol=1e-4, atol=1e-4)
    assert torch.equal(got_in.logits, got_t.logits)
    # each side builds its own kNN graphs: a neighbour near-tie may flip one
    # max in the encoder (tests/test_torch_port_modules.py), so count agreement
    assert np.isclose(got_in.w_q.numpy(), want_w_q, rtol=1e-4, atol=1e-4).mean() >= 0.99
    same = (got_t.one_hot_idx.numpy() == want['one_hot_idx']).all(-1)  # (n, T) slots with the same code
    assert same.mean() >= 0.99
    w_e = got_t.w_e.numpy().reshape(5, T, E)
    np.testing.assert_array_equal(w_e[same], want['w_e'].reshape(5, T, E)[same])


def test_build_and_merge_back_match_jax(pair):  # noqa: F811
    """The training shell built from a VQ-VAE's inner CVAE and codebook, and
    trained weights merged back into it (``train_w_autoencoder.py:39-88``)."""
    import copy

    from pccf.train.model import Model
    from train_w_autoencoder import build_w_train_model as jbuild, merge_back as jmerge
    from pccf_torch.train.w_autoencoder import build_w_train_model, merge_back
    from tests.test_torch_port_slice import OVERRIDES, port_config

    (_, _, jvq, vvq), (_, pvq), _ = pair
    pvq = copy.deepcopy(pvq)
    jvqm = Model(jvq, 'vq', variables=vvq)
    jw = jbuild(get_config_all(OVERRIDES), jvqm, reset=False)
    pw = build_w_train_model(port_config(), pvq, reset=False)
    want = flax_to_state_dict(jax.device_get(jw.variables))
    got = pw.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name

    trained = jax.tree.map(lambda a: np.asarray(a) + 0.5, jw.variables['params'])
    jw.variables = {**jw.variables, 'params': trained}
    load_port(pw, jw.variables)
    jmerge(jvqm, jw)
    merge_back(pvq, pw)
    merged = flax_to_state_dict(jax.device_get(jvqm.variables))
    state = pvq.state_dict()
    inner = [k for k in merged if k.startswith('w_autoencoder.')]
    assert inner and all(torch.equal(state[k], merged[k]) for k in merged)


def test_train_w_autoencoder_runs_on_the_cpu(pair):  # noqa: F811
    """The entry point at a tiny size: derived loaders, two epochs with a
    validation pass after each, the final test, the merge back."""
    import copy

    from pccf_torch.train.w_autoencoder import train_w_autoencoder
    from tests.test_torch_port_slice import port_config

    (_, _, _, _), (pcls, pvq), (clouds, _) = pair
    pvq = copy.deepcopy(pvq)
    cfg = port_config()
    cfg = tc.SliceConfig(data=cfg.data, classifier=cfg.classifier, autoencoder=cfg.autoencoder,
                         w_autoencoder=dataclasses.replace(cfg.w_autoencoder,
                                                              train=tc.WAutoEncoderTrainConfig(batch_size=2)))
    before = copy.deepcopy(pvq.w_autoencoder.state_dict())
    rng = np.random.default_rng(8)
    train, test = (torch.from_numpy((rng.standard_normal((n, 256, 3)) / 2).astype(np.float32)) for n in (4, 3))
    out = train_w_autoencoder(cfg, pvq, pcls, train, test, n_epochs=2, device='cpu')
    trainer = out['trainer']
    assert trainer.epoch == 2 and trainer.step == 4
    assert len(trainer.metrics_log) == len(trainer.validation_log) == 2
    assert np.isfinite(out['loss']) and out['loss'] == out['test']['Loss']
    assert out['test'] == trainer.validation_log[-1]  # the same weights, epoch and noise
    after = pvq.w_autoencoder.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before)

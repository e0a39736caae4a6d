"""The counterfactual evaluation suites of pccf_torch against the JAX package,
on the CPU.

One small flax CounterfactualVQVAE and classifier (``tests/test_torch_port_slice.py``'s
pair: 256 points, 128 code tokens, graph filtering on) converted into the
port; for the unconditional double reconstruction a plain VQVAE of the same
widths.  The noise is drawn by the test and handed to both packages: to the
port through the derived datasets' ``noise`` (or their ``draw``), to JAX by
monkeypatching its draws (the decoder's initial sampling enters its chunks,
the posterior's Gaussian noise replaces ``_gaussian_sample``'s, as
``tests/test_torch_port_wformer.py`` does).  Nothing in ``pccf`` is edited.

Tolerances: each side builds its own kNN graphs and VQ argmins, so code
indices are compared as agreement (>= 0.99 of the slots), and clouds whose
codes all agree at 1e-4 (float32 chains) at >= 99.5% of their points: graph
filtering's k = 4 neighbours of a decoded point can swap at a distance
near-tie, which moves that point by ~1e-3 (seen: one point of 256 in a
cloud), and no point may move by more than 1e-2; the original
classification exactly (accuracies) and 1e-4 (cross entropy); a derived
suite's metrics at 1e-4 where every code of its clouds agrees, else its
accuracy within the share of clouds whose codes differ.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs, Targets as JTargets
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.data.clouds import LabelledClouds
from pccf_torch.data.structures import Inputs

from tests.test_torch_port_modules import load_port, randomize_stats
from tests.test_torch_port_slice import N_POINTS, OVERRIDES, pair, port_config  # noqa: F401
from tests.test_torch_port_wformer import fixed_gaussian_sample

torch.set_num_threads(1)

T, Z1, Z2, SAMPLE_DIM = 128, 8, 6, 4  # the pair's code tokens, latent widths and decoder sampling width
CODE_AGREEMENT = 0.99


def _clouds(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, N_POINTS, 3)) / 2).astype(np.float32)


def _noise(n, seed):
    """Per-cloud decoder sampling and posterior draws, numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((n, N_POINTS, SAMPLE_DIM)).astype(f32),
            (rng.standard_normal((n, T, Z1)).astype(f32), rng.standard_normal((n, T, Z2)).astype(f32)))


def _jmodel(module, variables):
    from pccf.train.model import Model

    return Model(module, 'm', variables=variables)


@pytest.fixture(scope='module')
def plain_pair():
    """The unconditional VQVAE at the pair's widths, flax and port."""
    from pccf.models import get_autoencoder
    from pccf_torch.models import build_vqvae

    cfg = get_config_all([*OVERRIDES, 'autoencoder.model.class_name=VQVAE'])
    jvq = get_autoencoder(cfg)
    clouds = _clouds(2, 0)
    v = jax.jit(lambda rngs, inputs, logits: jvq.init(rngs, inputs, logits, method='full_init'))(
        {'params': jax.random.key(4), 'sampling': jax.random.key(5)}, JInputs(cloud=jnp.asarray(clouds)),
        jnp.zeros((2, 2)))
    v = randomize_stats(v, seed=4)
    pcfg = port_config()
    pvq = load_port(build_vqvae(dataclasses.replace(
        pcfg, autoencoder=dataclasses.replace(pcfg.autoencoder, class_name='VQVAE'))), v)
    assert not jvq.conditional and not pvq.conditional
    return jvq, v, pvq


def _jax_double(jvq, v, clouds, noise, logits=None):
    sampling, eps = noise
    inputs = JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling))
    with japi.force_backend('jnp'):
        if logits is None:
            return jvq.apply(v, inputs, method='double_reconstruct', rngs={'sampling': jax.random.key(0)})
        return jvq.apply(v, inputs, jnp.asarray(logits), method='double_reconstruct_with_logits',
                         rngs={'sampling': jax.random.key(0)})


def _port_double(pvq, clouds, noise, logits=None):
    sampling, eps = noise
    inputs = Inputs(cloud=torch.from_numpy(clouds), initial_sampling=torch.from_numpy(sampling))
    eps = tuple(torch.from_numpy(e) for e in eps)
    with torch.no_grad():
        if logits is None:
            return pvq.double_reconstruct(inputs, eps)
        return pvq.double_reconstruct_with_logits(inputs, torch.from_numpy(logits), eps)


def _assert_clouds_agree(got, want):
    """Clouds ``(n, points, 3)`` at 1e-4 at >= 99.5% of each cloud's points
    (a filtering near-tie moves a point), none past 1e-2."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean(-1).min() >= 0.995, close.mean(-1)
    assert float(np.abs(got - want).max()) <= 1e-2


def _assert_outputs_agree(got, want):
    """Codes as agreement, the clouds whose codes all agree as
    :func:`_assert_clouds_agree`; returns those clouds."""
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    same = (idx == jidx).all(axis=1)
    assert same.any()
    _assert_clouds_agree(got.recon.numpy()[same], np.asarray(want.recon)[same])
    return same


@pytest.mark.parametrize('conditional', [True, False])
def test_double_reconstruction_matches_jax(pair, plain_pair, monkeypatch, conditional):  # noqa: F811
    """``double_reconstruct_with_logits`` (conditional) and
    ``double_reconstruct`` (unconditional): encode, the inner CVAE's sampled
    forward in eval, decode its codes; the latents exactly as JAX's where
    the same draws enter."""
    clouds, noise = _clouds(3, 1), _noise(3, 2)
    logits = np.asarray([[0.3, -0.2], [-1.0, 0.5], [2.0, 0.0]], np.float32)
    if conditional:
        (_, _, jvq, v), (_, pvq), _ = pair
    else:
        jvq, v, pvq = plain_pair
        logits = None
    fixed_gaussian_sample(monkeypatch, noise[1])
    want = _jax_double(jvq, v, clouds, noise, logits)
    got = _port_double(pvq, clouds, noise, logits)
    for name in ('z1', 'z2', 'probs'):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-4)
    _assert_outputs_agree(got, want)


def test_unconditional_double_reconstruct_raises_on_a_conditional_model(pair):  # noqa: F811
    (_, _, jvq, v), (_, pvq), _ = pair
    clouds, noise = _clouds(1, 3), _noise(1, 4)
    with pytest.raises(ValueError, match='conditional model'):
        _jax_double(jvq, v, clouds, noise)
    with pytest.raises(ValueError, match='conditional model'):
        _port_double(pvq, clouds, noise)


# ------------------------------------------------------- derived datasets

N_DERIVED, CHUNK = 5, 2  # chunks of 2, 2 and 1
LABELS = np.asarray([0, 1, 1, 0, 1])
DERIVED = ['DoubleReconstructedDatasetEncoder', 'DoubleReconstructedDatasetWithLogits',
           'CounterfactualDatasetEncoder', 'BoundaryDataset']


def _jax_chunk_noise(monkeypatch, chunks):
    """JAX's derived datasets take each chunk's initial sampling and
    posterior draws from ``chunks``, unjitted (a jitted pass would keep its
    first draws)."""
    from pccf.data import processed as jprocessed
    from pccf.models.w_autoencoders import WAutoEncoder

    real = jprocessed.ProcessedDataset._chunks
    draws, eps_queue = iter(chunks), []

    def chunked(self, idx_list):
        for inputs, labels in real(self, idx_list):
            sampling, eps = next(draws)
            eps_queue.extend(eps or ())
            yield inputs._replace(initial_sampling=jnp.asarray(sampling)), labels

    monkeypatch.setattr(jprocessed.ProcessedDataset, '_chunks', chunked)
    monkeypatch.setattr(jprocessed.ProcessedDataset, '_jit', lambda self, name, fn: fn)
    monkeypatch.setattr(WAutoEncoder, '_gaussian_sample',
                        lambda self, mu, log_var: jnp.asarray(eps_queue.pop(0)) * jnp.exp(0.5 * log_var) + mu)
    monkeypatch.setattr(jprocessed.ProcessedDataset, 'max_batch', CHUNK)


@pytest.mark.parametrize('name', DERIVED)
def test_derived_dataset_matches_jax(pair, plain_pair, monkeypatch, name):  # noqa: F811
    """Each derived dataset over 5 labelled clouds, chunked at 2, against
    ``pccf/data/processed.py``'s: the clouds where the codes of the direct
    model calls agree on both sides, and the labels (``target_dim`` for the
    counterfactual datasets, ``processed.py:243-245``)."""
    from pccf.data import processed as jprocessed
    from pccf_torch.data import processed

    (jcls, vcls, jvq, vvq), (pcls, pvq), _ = pair
    if name == 'DoubleReconstructedDatasetEncoder':
        jvq, vvq, pvq = plain_pair
    clouds = _clouds(N_DERIVED, 10)
    sampling, eps = _noise(N_DERIVED, 11)
    stochastic = name.startswith('Double')
    chunks = [(sampling[s], tuple(e[s] for e in eps) if stochastic else None)
              for s in (slice(0, 2), slice(2, 4), slice(4, 5))]
    _jax_chunk_noise(monkeypatch, chunks)
    monkeypatch.setattr(processed, 'MAX_BATCH', CHUNK)
    extra = {'CounterfactualDatasetEncoder': (1, 1.0), 'BoundaryDataset': (1,)}.get(name, ())
    backing = [(JInputs(cloud=c), JTargets(ref_cloud=c, label=np.int64(lb))) for c, lb in zip(clouds, LABELS)]
    jargs = (backing, _jmodel(jvq, vvq)) + (() if name == 'DoubleReconstructedDatasetEncoder' else
                                            (_jmodel(jcls, vcls),))
    with japi.force_backend('jnp'):
        items = getattr(jprocessed, name)(*jargs, *extra).__getitems__(list(range(N_DERIVED)))
    port_chunks = iter([(torch.from_numpy(s), tuple(torch.from_numpy(x) for x in e) if e else None)
                        for s, e in chunks])
    pargs = (LabelledClouds(torch.from_numpy(clouds), torch.from_numpy(LABELS)), pvq) + (
        () if name == 'DoubleReconstructedDatasetEncoder' else (pcls,))
    dataset = getattr(processed, name)(*pargs, *extra, noise=lambda n: next(port_chunks))
    got_in, got_t = dataset.__getitems__(list(range(N_DERIVED)))
    want = np.stack([np.asarray(inp.cloud) for inp, _ in items])
    labels = [int(t.label) for _, t in items]
    assert got_t.label.tolist() == labels == ([1] * N_DERIVED if extra else LABELS.tolist())
    assert torch.equal(got_in.cloud, got_t.ref_cloud) and got_in.cloud.shape == (N_DERIVED, N_POINTS, 3)

    # the codes of the same clouds and draws, from the models directly
    with japi.force_backend('jnp'):
        logits = np.asarray(jcls.apply(vcls, JInputs(cloud=jnp.asarray(clouds))))
    if stochastic:
        fixed_gaussian_sample(monkeypatch, eps)
        jout = _jax_double(jvq, vvq, clouds, (sampling, eps), logits if name.endswith('Logits') else None)
        with torch.no_grad():
            plog = pcls(Inputs(torch.from_numpy(clouds))).numpy()
        pout = _port_double(pvq, clouds, (sampling, eps), plog if name.endswith('Logits') else None)
    else:
        value = 1.0 if name == 'CounterfactualDatasetEncoder' else 0.0
        with japi.force_backend('jnp'):
            jout = jvq.apply(vvq, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(sampling)),
                             jnp.asarray(logits), 1, value, method='generate_counterfactual')
        with torch.no_grad():
            inputs = Inputs(torch.from_numpy(clouds), initial_sampling=torch.from_numpy(sampling))
            pout = pvq.generate_counterfactual(inputs, pcls(Inputs(inputs.cloud)), 1, value)
    same = _assert_outputs_agree(pout, jout)
    _assert_clouds_agree(got_in.cloud.numpy()[same], want[same])


def test_derived_dataset_computes_each_chunk_once_a_pass(pair):  # noqa: F811
    """A fetch computes the chunks its indices fall in and keeps them for the
    next fetches; a new pass (``set_inference``) draws fresh noise."""
    from pccf_torch.data import processed

    (_, _, _, _), (pcls, pvq), _ = pair
    calls = []

    def noise(n):
        calls.append(n)
        sampling, _ = _noise(n, len(calls))
        return torch.from_numpy(sampling), None

    clouds = LabelledClouds(torch.from_numpy(_clouds(3, 20)), torch.tensor([0, 1, 0]))
    dataset = processed.CounterfactualDatasetEncoder(clouds, pvq, pcls, 0, noise=noise)
    first = dataset.__getitems__([1])[0].cloud
    again = dataset.__getitems__([0, 2])[0].cloud
    assert calls == [3]  # one chunk of the three clouds
    both = dataset.__getitems__([1, 0])[0].cloud
    assert torch.equal(both[0], first[0]) and torch.equal(both[1], again[0])
    dataset.set_inference(True)
    fresh = dataset.__getitems__([1])[0].cloud
    assert calls == [3, 3] and not torch.equal(fresh, first)


def test_derived_noise_is_the_same_on_any_device(pair):  # noqa: F811
    """The draws come from a host generator seeded by the backing data's
    seed: two datasets over the same seed draw the same noise, another seed
    other noise."""
    from pccf_torch.data import processed

    (_, _, _, _), (pcls, pvq), _ = pair

    def draw(seed):
        clouds = LabelledClouds(torch.from_numpy(_clouds(2, 21)), torch.tensor([0, 1]), seed=seed)
        return processed.DoubleReconstructedDatasetWithLogits(clouds, pvq, pcls).draw(2)

    (s1, (e1, f1)), (s2, (e2, f2)), (s3, _) = draw(7), draw(7), draw(8)
    assert torch.equal(s1, s2) and torch.equal(e1, e2) and torch.equal(f1, f2) and not torch.equal(s1, s3)
    assert s1.shape == (2, N_POINTS, SAMPLE_DIM) and e1.shape == (2, T, Z1) and f1.shape == (2, T, Z2)


# ------------------------------------------------------------ the suites

N_SUITE, SUITE_BATCH = 12, 4


class _JClouds:
    """The JAX suites' backing dataset: labelled clouds by index."""

    seed = 0

    def __init__(self, clouds, labels):
        self.clouds, self.labels = clouds, labels

    def __len__(self):
        return len(self.clouds)

    def __getitem__(self, i):
        return JInputs(cloud=self.clouds[i]), JTargets(ref_cloud=self.clouds[i], label=np.int64(self.labels[i]))

    def set_inference(self, inference):
        pass


def test_five_suites_match_jax(pair, monkeypatch):  # noqa: F811
    """The five suites end to end on 12 clouds in batches of 4, against
    ``evaluate_counterfactuals.py``'s suite functions, every cloud given the
    same decoder sampling and posterior draws on both sides: the original
    classification exactly, the derived suites (and the merged ones) where
    the codes of their clouds agree."""
    import evaluate_counterfactuals as jec
    from pccf.data import processed as jprocessed
    from pccf.models.w_autoencoders import WAutoEncoder
    from pccf.train import DataLoader
    from pccf_torch.data import processed
    from pccf_torch.evaluate_counterfactuals import evaluate_counterfactuals

    (jcls, vcls, jvq, vvq), (pcls, pvq), _ = pair
    clouds = _clouds(N_SUITE, 30)
    labels = np.asarray([0, 1] * (N_SUITE // 2))
    sampling, (e1, e2) = _noise(1, 31)
    eps = {Z1: e1[0], Z2: e2[0]}

    # JAX: every chunk's clouds take the same draws
    real = jprocessed.ProcessedDataset._chunks

    def chunked(self, idx_list):
        for inputs, chunk_labels in real(self, idx_list):
            shape = (len(chunk_labels), N_POINTS, SAMPLE_DIM)
            yield inputs._replace(initial_sampling=jnp.broadcast_to(jnp.asarray(sampling[0]), shape)), chunk_labels

    monkeypatch.setattr(jprocessed.ProcessedDataset, '_chunks', chunked)
    monkeypatch.setattr(WAutoEncoder, '_gaussian_sample',
                        lambda self, mu, log_var: jnp.asarray(eps[mu.shape[-1]]) * jnp.exp(0.5 * log_var) + mu)
    recorded = {}
    monkeypatch.setattr(jec, 'print_suite', lambda name, test: recorded.__setitem__(name, test.objective.copy()))
    jds = _JClouds(clouds, labels)
    jc, jv = _jmodel(jcls, vcls), _jmodel(jvq, vvq)
    with japi.force_backend('jnp'):
        original = jec.evaluate_original(jc, DataLoader(jds, SUITE_BATCH))
        jec.evaluate_reconstructed(jc, jds, jv, SUITE_BATCH)
        jec.evaluate_counterfactual_performance(jc, jds, jv, 2, SUITE_BATCH, 1.0)
        jlogits = np.concatenate([np.asarray(o) for o in original.outputs_list])
        predictions = jlogits.argmax(axis=1)
        jec.evaluate_misclassified(jc, jds, jv, labels, predictions, SUITE_BATCH)
        jec.evaluate_class_transitions(jc, jds, jv, labels, predictions, 2, SUITE_BATCH, 1.0)

    # the port: the same draws for every chunk's clouds
    def draw(self, n):
        out = torch.from_numpy(sampling[0]).expand(n, -1, -1), None
        if self.stochastic:
            out = out[0], (torch.from_numpy(e1[0]).expand(n, -1, -1), torch.from_numpy(e2[0]).expand(n, -1, -1))
        return out

    monkeypatch.setattr(processed.ProcessedDataset, 'draw', draw)
    cfg = port_config()
    cfg = dataclasses.replace(cfg, classifier=dataclasses.replace(
        cfg.classifier, train=tc.ClassifierTrainConfig(batch_size=SUITE_BATCH)))
    got = evaluate_counterfactuals(cfg, pcls, pvq, torch.from_numpy(clouds), torch.from_numpy(labels), device='cpu')

    # merged as the JAX suites merge
    want = {name: obj.compute_metrics() for name, obj in recorded.items()}
    for merged, names in (('OverallCounterfeit', ['Counterfeit_to_0', 'Counterfeit_to_1']),
                          ('OverallMisclassifiedCounterfeit', [n for n in recorded if n[0].isdigit()])):
        if names:
            obj = recorded[names[0]].copy()
            for n in names[1:]:
                obj.merge_state(recorded[n])
            want[merged] = obj.compute_metrics()
    assert set(got) == set(want) and 'MisclassifiedReconstructed' in got
    assert margins(jlogits) > 1e-3  # no argmax near-tie: classification must agree exactly
    orig = got['ClassificationOriginal']
    assert orig['Accuracy'] == want['ClassificationOriginal']['Accuracy']
    assert orig['Macro Accuracy'] == want['ClassificationOriginal']['Macro Accuracy']
    assert orig['CrossEntropy'] == pytest.approx(want['ClassificationOriginal']['CrossEntropy'], rel=1e-4)

    # the codes of every derived cloud on both sides (the same draws for every cloud)
    with japi.force_backend('jnp'):
        logits = np.asarray(jcls.apply(vcls, JInputs(cloud=jnp.asarray(clouds))))
    noise = (np.broadcast_to(sampling, (N_SUITE, N_POINTS, SAMPLE_DIM)).copy(),
             (np.broadcast_to(e1, (N_SUITE, T, Z1)).copy(), np.broadcast_to(e2, (N_SUITE, T, Z2)).copy()))
    fixed_gaussian_sample(monkeypatch, noise[1])
    with torch.no_grad():
        plog = pcls(Inputs(torch.from_numpy(clouds))).numpy()
    differ = {'recon': ~_same_codes(_port_double(pvq, clouds, noise, plog), _jax_double(jvq, vvq, clouds, noise,
                                                                                         logits))}
    for j in range(2):
        with japi.force_backend('jnp'):
            jout = jvq.apply(vvq, JInputs(cloud=jnp.asarray(clouds), initial_sampling=jnp.asarray(noise[0])),
                             jnp.asarray(logits), j, 1.0, method='generate_counterfactual')
        with torch.no_grad():
            pout = pvq.generate_counterfactual(Inputs(torch.from_numpy(clouds), initial_sampling=torch.from_numpy(
                noise[0])), torch.from_numpy(plog), j, 1.0)
        differ[j] = ~_same_codes(pout, jout)
    everyone = np.ones(N_SUITE, bool)
    members = {'ClassificationReconstructed': ('recon', everyone), 'Counterfeit_to_0': (0, everyone),
               'Counterfeit_to_1': (1, everyone), 'MisclassifiedReconstructed': ('recon', predictions != labels)}
    for i, j in ((0, 1), (1, 0)):
        members[f'{i}_to_{j}'] = (j, (predictions == i) & (labels == j))
    for name, (codes, mask) in members.items():
        if name in want:
            _suite_agrees(got[name], want[name], differ[codes][mask].sum(), mask.sum(), name)
    merged = {'OverallCounterfeit': ['Counterfeit_to_0', 'Counterfeit_to_1'],
              'OverallMisclassifiedCounterfeit': [n for n in want if n[0].isdigit()]}
    for name, parts in merged.items():
        if parts:
            n_differ = sum(differ[members[p][0]][members[p][1]].sum() for p in parts)
            _suite_agrees(got[name], want[name], n_differ, sum(members[p][1].sum() for p in parts), name)


def margins(logits):
    top = np.sort(logits, axis=1)
    return float((top[:, -1] - top[:, -2]).min())


def _same_codes(got, want):
    idx, jidx = got.idx.numpy(), np.asarray(want.idx)
    assert (idx == jidx).mean() >= CODE_AGREEMENT
    return (idx == jidx).all(axis=1)


def _suite_agrees(got, want, n_differ, n, name):
    """All metrics where every cloud's codes agree, else the accuracy within
    the share of clouds whose codes differ."""
    assert set(got) == set(want), name
    if n_differ == 0:
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-4, abs=1e-6), (name, key)
    else:
        assert abs(got['Accuracy'] - want['Accuracy']) <= n_differ / n + 1e-9, name

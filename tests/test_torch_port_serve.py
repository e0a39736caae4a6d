"""The port's server (``pccf_torch/serve.py``) on the CPU: the mirror of
``tests/test_serve.py``.

The model is ``tests/test_torch_port_slice.py``'s small configuration (256
points, 128 code tokens of width 128, graph filtering on), with random
weights from a seed; on the CPU every kernel wrapper runs its plain
version.  Covered, as ``tests/test_serve.py`` covers them: bucketing (with
the default buckets up to 64, as ``pccf/serve.py:48`` has them),
counterfactual requests and their padding, ``counterfactual_async``,
microbatching (``submit`` / ``flush``, the two threading regressions, a
flush on a second thread), generation (determinism, given ``probs``,
oversize chunks, chunk seeds) and warmup (its coverage, its neutrality on
``stats``).  Left out: ``TestMeshServing`` and ``TestBF16``, since the port
has no mesh serving and no bf16 weight cast yet.

Tolerances as in ``tests/test_serve.py``: outputs of one request in other
batches within 1e-5 or 1e-4; a rerun and an asynchronous request equal to
the synchronous one bit for bit (the same device, the same batches).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from pccf_torch import serve
from pccf_torch.models import build_vqvae
from pccf_torch.nn import build_classifier
from pccf_torch.nn.layers import init_from_seed
from pccf_torch.serve import DEFAULT_BUCKETS, CounterfactualServer, next_bucket, pad_batch

from tests.test_torch_port_slice import N_POINTS, port_config

torch.set_num_threads(1)

N_IN = N_POINTS
N_CLASSES = 2


def _models(seed=0, classifier=True):
    cfg = port_config()
    vq = build_vqvae(cfg)
    init_from_seed(vq, seed)
    if not classifier:
        return vq, None
    cls = build_classifier(cfg)
    init_from_seed(cls, seed + 1)
    return vq, cls


@pytest.fixture(scope='module')
def server():
    return CounterfactualServer(*_models(), buckets=(2, 4))


def _clouds(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, N_IN, 3)).astype(np.float32) / 2


class TestBucketing:
    def test_next_bucket(self):
        assert next_bucket(1, (2, 4)) == 2
        assert next_bucket(3, (2, 4)) == 4
        assert next_bucket(9, (2, 4)) == 4  # oversize -> chunking bucket

    def test_pad_batch(self):
        x = np.ones((3, 5))
        p = pad_batch(x, 4)
        assert p.shape == (4, 5) and p[3].sum() == 0.0

    def test_bad_buckets_rejected(self, server):
        with pytest.raises(ValueError):
            CounterfactualServer(server.vqvae, buckets=(4, 2))

    def test_default_buckets_reach_64(self):
        """The JAX server's buckets (``pccf/serve.py:48``): a request of 20
        is one batch of bucket 32, padded by 12, not two chunks of 16."""
        assert DEFAULT_BUCKETS == (1, 2, 4, 8, 16, 32, 64)
        srv = CounterfactualServer(*_models(seed=4))
        assert srv.buckets == DEFAULT_BUCKETS
        out = srv.counterfactual(_clouds(20, seed=30), 1, np.zeros((20, N_CLASSES), np.float32))
        assert out.shape == (20, N_IN, 3) and np.isfinite(out).all()
        assert srv.stats == {'served': 20, 'batches': 1, 'padded': 12}


class TestStats:
    def test_stats_are_bumped_under_the_lock(self, server):
        """``stats`` change only while ``_stats_lock`` is held (``pccf/serve.py:369-375``)."""
        before = dict(server.stats)
        done = threading.Event()
        with server._stats_lock:
            worker = threading.Thread(target=lambda: (server._bump_stats(3, 4), done.set()))
            worker.start()
            assert not done.wait(0.2)
            assert server.stats == before
        worker.join(timeout=10)
        assert not worker.is_alive() and done.is_set()
        assert server.stats == {'served': before['served'] + 3, 'batches': before['batches'] + 1,
                                'padded': before['padded'] + 1}

    def test_concurrent_bumps_are_not_lost(self, server):
        """More threads than cores bump at once with a short switch
        interval: every update counts."""
        before = dict(server.stats)
        threads, reps = 16, 2000
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=lambda: [server._bump_stats(1, 2) for _ in range(reps)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(w.is_alive() for w in workers)
        n = threads * reps
        assert server.stats == {'served': before['served'] + n, 'batches': before['batches'] + n,
                                'padded': before['padded'] + n}


class TestServing:
    def test_counterfactual_pads_and_unpads(self, server):
        out = server.counterfactual(_clouds(3), target_dim=1)
        assert out.shape == (3, N_IN, 3)
        assert np.isfinite(out).all()

    def test_prepacked_server_is_deterministic(self):
        """The server folds the fused paths' weights when it starts; every
        call reads that fold and returns the same output."""
        srv = CounterfactualServer(*_models(seed=2), buckets=(2,))
        assert srv.vqvae.w_autoencoder.packed is not None and srv.vqvae.decoder.packed is not None
        clouds = _clouds(2, seed=9)
        np.testing.assert_array_equal(srv.counterfactual(clouds, target_dim=0), srv.counterfactual(clouds, 0))

    def test_oversize_batch_chunks_match_single_requests(self, server):
        clouds = _clouds(6, seed=1)
        logits = server.classify(clouds)
        whole = server.counterfactual(clouds, 0, logits)
        parts = np.concatenate(
            [server.counterfactual(clouds[i : i + 2], 0, logits[i : i + 2]) for i in (0, 2, 4)]
        )
        np.testing.assert_allclose(whole, parts, atol=1e-5)

    def test_async_matches_sync(self, server):
        """``counterfactual_async().result()`` is the synchronous path, and
        futures dispatched back to back do not cross."""
        clouds = _clouds(4, seed=17)
        logits = server.classify(clouds)
        sync = server.counterfactual(clouds, 1, logits)
        f1 = server.counterfactual_async(clouds[:2], 1, logits[:2])
        f2 = server.counterfactual_async(clouds[2:], 1, logits[2:])
        assert isinstance(f1, serve.ServeFuture)
        np.testing.assert_array_equal(np.concatenate([f1.result(), f2.result()]), sync)
        np.testing.assert_array_equal(f1.result(), sync[:2])  # a result can be read again

    def test_async_oversize_chunks_dispatch_up_front(self, server):
        clouds = _clouds(5, seed=18)
        logits = server.classify(clouds)
        before = server.stats['batches']
        fut = server.counterfactual_async(clouds, 0, logits)
        assert server.stats['batches'] == before + 2  # both chunks dispatched before result()
        np.testing.assert_array_equal(fut.result(), server.counterfactual(clouds, 0, logits))

    def test_per_sample_targets_match_per_row_calls(self, server):
        clouds = _clouds(2, seed=2)
        logits = server.classify(clouds)
        tdim = np.asarray([0, 1])
        tval = np.asarray([1.0, 0.5])
        mixed = server.counterfactual(clouds, tdim, logits, tval)
        for i in range(2):
            solo = server.counterfactual(clouds[i : i + 1], int(tdim[i]), logits[i : i + 1], float(tval[i]))
            np.testing.assert_allclose(mixed[i], solo[0], atol=1e-4)

    def test_padding_does_not_change_results(self, server):
        clouds = _clouds(2, seed=3)
        logits = server.classify(clouds)
        single = server.counterfactual(clouds[:1], 1, logits[:1])
        pair = server.counterfactual(clouds, 1, logits)
        np.testing.assert_allclose(single[0], pair[0], atol=1e-4)

    def test_classify_without_classifier_raises(self):
        srv = CounterfactualServer(*_models(seed=3, classifier=False), buckets=(2,))
        with pytest.raises(ValueError):
            srv.classify(_clouds(1))
        out = srv.counterfactual(_clouds(1), 0, logits=np.zeros((1, N_CLASSES), np.float32))
        assert out.shape[0] == 1
        with pytest.raises(ValueError, match='requires logits'):
            srv.submit(_clouds(1)[0], 0)


class TestMicrobatching:
    def test_submit_flush_round_trip(self, server):
        clouds = _clouds(3, seed=4)
        logits = server.classify(clouds)
        tickets = [server.submit(clouds[i], target_dim=i % 2, logits=logits[i]) for i in range(3)]
        results = server.flush()
        assert sorted(results) == sorted(tickets)
        direct = server.counterfactual(clouds, np.asarray([0, 1, 0]), logits)
        for i, t in enumerate(tickets):
            np.testing.assert_allclose(results[t], direct[i], atol=1e-4)
        assert server.flush() == {}  # queue drained

    def test_submit_validates_shapes(self, server):
        with pytest.raises(ValueError):
            server.submit(np.zeros((N_IN, 2), np.float32), 0)  # not (N, 3)
        t = server.submit(np.zeros((N_IN, 3), np.float32), 0)
        with pytest.raises(ValueError):
            server.submit(np.zeros((N_IN * 2, 3), np.float32), 0)  # mixed N
        assert t in server.flush()  # valid request still redeemable

    def test_flush_fills_missing_logits_from_classifier(self, server, monkeypatch):
        """Only the entries without logits are classified."""
        clouds = _clouds(3, seed=5)
        given = server.classify(clouds[1:2])[0]
        t0 = server.submit(clouds[0], target_dim=0)  # no logits
        t1 = server.submit(clouds[1], target_dim=1, logits=given)
        t2 = server.submit(clouds[2], target_dim=1)
        real_classify, classified = server.classify, []
        monkeypatch.setattr(server, 'classify', lambda c: classified.append(len(c)) or real_classify(c))
        results = server.flush()
        assert set(results) == {t0, t1, t2} and classified == [2]
        assert all(np.isfinite(v).all() for v in results.values())
        want = server.counterfactual(clouds, [0, 1, 1], np.stack([real_classify(clouds[:1])[0], given,
                                                                  real_classify(clouds[2:])[0]]))
        for i, t in enumerate((t0, t1, t2)):
            np.testing.assert_allclose(results[t], want[i], atol=1e-4)

    def test_failed_flush_keeps_its_tickets(self, server, monkeypatch):
        clouds = _clouds(1, seed=10)
        t0 = server.submit(clouds[0], 0, logits=np.zeros(N_CLASSES, np.float32))

        def fail(*args, **kwargs):
            raise RuntimeError('device lost')

        monkeypatch.setattr(server, 'counterfactual', fail)
        with pytest.raises(RuntimeError):
            server.flush()
        monkeypatch.undo()
        assert set(server.flush()) == {t0}

    def test_flush_keeps_requests_submitted_while_serving(self, server, monkeypatch):
        """A submit() landing while flush()'s device work is in flight stays
        queued for the next flush."""
        clouds = _clouds(3, seed=6)
        logits = server.classify(clouds)
        t0 = server.submit(clouds[0], 0, logits=logits[0])
        real_cf = server.counterfactual
        late: list[int] = []

        def cf_and_submit(*args, **kwargs):
            out = real_cf(*args, **kwargs)
            if not late:  # mid-flush arrival, after the queue snapshot
                late.append(server.submit(clouds[1], 1, logits=logits[1]))
            return out

        monkeypatch.setattr(server, 'counterfactual', cf_and_submit)
        first = server.flush()
        assert set(first) == {t0}
        second = server.flush()
        assert set(second) == set(late)  # late ticket served, not dropped

    def test_overlapping_flushes_do_not_drop_new_submits(self, server, monkeypatch):
        """Two flushes sharing a snapshot must not double-drain: the drain is
        by ticket identity, not by the snapshot's length."""
        clouds = _clouds(2, seed=8)
        logits = server.classify(clouds)
        t0 = server.submit(clouds[0], 0, logits=logits[0])
        real_cf = server.counterfactual
        state: dict = {}

        def cf(*args, **kwargs):
            out = real_cf(*args, **kwargs)
            if not state.get('fired'):
                state['fired'] = True
                state['inner'] = server.flush()
                state['late'] = server.submit(clouds[1], 1, logits=logits[1])
            return out

        monkeypatch.setattr(server, 'counterfactual', cf)
        outer = server.flush()
        assert set(state['inner']) == {t0}
        assert set(outer) == {t0}
        final = server.flush()
        assert set(final) == {state['late']}, 'late submit was dropped by double-drain'

    def test_flush_on_a_second_thread_while_submits_land(self, server, monkeypatch):
        """A flush on another thread runs in inference mode (thread-local in
        PyTorch) and serves its snapshot while the main thread submits; the
        requests that landed meanwhile stay queued, and every ticket is
        served once, equal to the batch served directly."""
        clouds = _clouds(5, seed=12)
        logits = server.classify(clouds)
        real_cf, modes = server.counterfactual, []
        started, resume = threading.Event(), threading.Event()

        def cf(*args, **kwargs):
            modes.append(torch.is_inference_mode_enabled())
            started.set()
            assert resume.wait(30)
            return real_cf(*args, **kwargs)

        early = [server.submit(clouds[i], i % 2, logits=logits[i]) for i in range(3)]
        monkeypatch.setattr(server, 'counterfactual', cf)
        results: dict = {}
        worker = threading.Thread(target=lambda: results.update(server.flush()))
        worker.start()
        assert started.wait(30)
        late = [server.submit(clouds[i], i % 2, logits=logits[i]) for i in range(3, 5)]
        resume.set()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert modes == [True] and set(results) == set(early)
        monkeypatch.undo()
        rest = server.flush()
        assert set(rest) == set(late)
        results.update(rest)
        direct = server.counterfactual(clouds, np.arange(5) % 2, logits)
        for i, t in enumerate(early + late):
            np.testing.assert_allclose(results[t], direct[i], atol=1e-4)


class TestGenerate:
    def test_generate_shapes_and_determinism(self, server):
        a = server.generate(3, seed=1)
        b = server.generate(3, seed=1)
        assert a.shape == (3, N_IN, 3) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
        c = server.generate(3, seed=2)
        assert np.abs(a - c).max() > 1e-4  # distinct draws per seed

    def test_generate_with_probs(self, server):
        probs = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
        out = server.generate(2, probs=probs)
        assert out.shape[0] == 2 and np.isfinite(out).all()
        assert np.abs(out - server.generate(2, probs=probs[::-1].copy())).max() > 1e-4

    def test_generate_oversize_chunks(self, server):
        before = dict(server.stats)
        out = server.generate(9)  # buckets (2, 4): chunks of 4, 4 and 1 (bucket 2)
        assert out.shape[0] == 9 and np.isfinite(out).all()
        assert server.stats == {'served': before['served'] + 9, 'batches': before['batches'] + 3,
                                'padded': before['padded'] + 1}

    def test_generate_chunk_seeds_do_not_collide_with_user_seeds(self, server):
        """A later chunk of one call must not reproduce another call's first
        chunk (the seed + offset scheme would give generate(8, seed=0)[4:]
        == generate(4, seed=4))."""
        whole = server.generate(8, seed=0)  # two chunks of bucket 4
        first = server.generate(4, seed=0)
        np.testing.assert_array_equal(whole[:4], first)  # chunk determinism
        for s in range(1, 6):
            other = server.generate(4, seed=s)
            assert np.abs(whole[4:] - other).max() > 1e-5

    def test_generation_scaffold_differs_from_a_requests(self, server):
        """Generation's draws for seed s, chunk c never share a stream with
        the counterfactual request of seed s (nor with seed s's other
        chunks)."""
        for s in (0, 1, 5):
            request = server.initial_sampling(np.asarray([s]))[0]
            for chunk in (0, 1):
                _, sampling = server.generation_draws(1, s, chunk)
                assert not torch.equal(sampling[0], request)
        assert not torch.equal(server.generation_draws(1, 1, 0)[1], server.generation_draws(1, 0, 1)[1])
        assert torch.equal(server.generation_draws(2, 3, 1)[1], server.generation_draws(2, 3, 1)[1])


class TestWarmup:
    def test_warmup_covers_all_entry_points(self, monkeypatch):
        """warmup() drives counterfactual, classify and generate (with and
        without probs) at every bucket, and the server serves afterwards."""
        srv = CounterfactualServer(*_models(seed=5), buckets=(1, 2))
        calls = []
        for name in ('counterfactual', 'classify', 'generate'):
            real = getattr(srv, name)
            monkeypatch.setattr(srv, name, lambda *a, _real=real, _name=name, **kw: (
                calls.append((_name, len(a[0]) if _name != 'generate' else a[0], kw.get('probs') is not None)),
                _real(*a, **kw))[1])
        srv.warmup(N_IN, N_CLASSES)
        assert calls == [(name, b, probs) for b in (1, 2) for name, probs in (
            ('counterfactual', False), ('classify', False), ('generate', False), ('generate', True))]
        monkeypatch.undo()
        out = srv.counterfactual(_clouds(1, seed=8), 0)
        assert out.shape == (1, N_IN, 3) and np.isfinite(out).all()
        g = srv.generate(2)
        assert g.shape[0] == 2 and np.isfinite(g).all()
        calls.clear()
        srv.warmup(N_IN, N_CLASSES, buckets=(2,), generate=False)
        assert srv.stats == {'served': 3, 'batches': 2, 'padded': 0}  # the two requests above

    def test_warmup_is_stats_neutral(self, server):
        base = dict(server.stats)
        server.warmup(N_IN, N_CLASSES, generate=False)
        assert server.stats == base
        server.warmup(N_IN, N_CLASSES)
        assert server.stats == base
        server.counterfactual(_clouds(1, seed=21), 0, np.zeros((1, N_CLASSES), np.float32), 1.0)
        assert server.stats['served'] == base['served'] + 1
        assert server.stats['batches'] == base['batches'] + 1

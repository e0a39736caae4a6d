"""The port's serving artifacts (``pccf_torch/export.py``) on the CPU: the
contracts of ``tests/test_export.py`` held on a ``torch.export`` artifact,
the serving kernels as ``torch.library`` custom ops
(``pccf_torch/kernels/library.py``) under ``torch.library.opcheck``, the
bf16-cast server's artifact, and the entry point
``python -m pccf_torch.export_artifact``.

The model is ``tests/test_torch_port_slice.py``'s small configuration with
clouds of ``N_IN = 64`` points in (256 out, 128 code tokens of width 128,
PCGen (512, 512, 64, 16) with G = 2, graph filtering on), so every serving
op runs: kNN and the eval max-pool in the encoders, the CVAE chain, PCGen's
kernel, the W-decoder's stack in generation and graph filtering.  Random
weights from a seed, buckets (2, 4).  The artifact holds the live server
at ``atol=1e-5``, as ``tests/test_export.py`` holds JAX's (the same ops on
the same device: it is bit-equal here).  The comparisons with the JAX
package's artifact are in ``tests/test_torch_export_jax.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pccf_torch import cli, export_artifact
from pccf_torch.config import ExportConfig
from pccf_torch.export import export_server, load_artifact
from pccf_torch.kernels import library, wformer
from pccf_torch.models import build_vqvae
from pccf_torch.nn import build_classifier
from pccf_torch.nn.layers import init_from_seed
from pccf_torch.serve import CounterfactualServer

from tests.test_torch_port_slice import port_config

torch.set_num_threads(1)

N_IN = 64
N_CLASSES = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config():
    cfg = port_config()
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_input_points=N_IN))


def models(seed=0):
    cfg = config()
    vq, cls = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vq, seed)
    init_from_seed(cls, seed + 1)
    return vq, cls


@pytest.fixture(scope='module')
def server():
    return CounterfactualServer(*models(), buckets=(2, 4))


@pytest.fixture(scope='module')
def artifact(server, tmp_path_factory):
    path = tmp_path_factory.mktemp('artifact')
    manifest = export_server(server, path, N_IN, N_CLASSES)
    return load_artifact(path), manifest, path


def _clouds(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, N_IN, 3)).astype(np.float32) / 2


class TestExport:
    def test_manifest_written(self, artifact):
        art, manifest, path = artifact
        on_disk = json.loads((path / 'manifest.json').read_text())
        assert on_disk == manifest
        assert set(manifest['endpoints']) == {'counterfactual', 'classify', 'generate'}
        assert manifest['n_points'] == N_IN and manifest['n_out'] == 256
        assert manifest['buckets'] == [2, 4] and manifest['platforms'] == ['cpu']
        for ep in manifest['endpoints'].values():
            entry = ep['cpu']
            assert 'poly' in entry, entry.get('poly_error')  # the symbolic batch held
            assert (path / entry['poly']).stat().st_size == entry['bytes'] > 1000
            assert entry['seconds'] > 0

    def test_classify_matches_live_server(self, server, artifact):
        art, _, _ = artifact
        clouds = _clouds(3, seed=1)
        np.testing.assert_allclose(art.classify(clouds), server.classify(clouds), atol=1e-5)

    def test_counterfactual_matches_live_server(self, server, artifact):
        """The same device and the same seeds: the artifact draws the
        scaffold as the live server does and reproduces it."""
        art, _, _ = artifact
        clouds = _clouds(2, seed=2)
        logits = server.classify(clouds)
        live = server.counterfactual(clouds, 1, logits, 0.75, sampling_seed=5)
        exported = art.counterfactual(clouds, 1, logits, 0.75, sampling_seed=5)
        np.testing.assert_allclose(exported, live, atol=1e-5)
        per_sample = art.counterfactual(clouds, [1, 0], logits, [0.75, 0.5], sampling_seed=[5, 6])
        np.testing.assert_allclose(per_sample, server.counterfactual(clouds, [1, 0], logits, [0.75, 0.5], [5, 6]),
                                   atol=1e-5)

    def test_counterfactual_without_logits_uses_exported_classifier(self, server, artifact):
        art, _, _ = artifact
        clouds = _clouds(2, seed=3)
        np.testing.assert_allclose(art.counterfactual(clouds, 0), server.counterfactual(clouds, 0), atol=1e-5)

    def test_batch_sizes_beyond_buckets_chunk(self, server, artifact):
        art, _, _ = artifact
        clouds = _clouds(7, seed=4)  # > max bucket 4 -> chunked
        logits = server.classify(clouds)
        np.testing.assert_allclose(art.counterfactual(clouds, 0, logits), server.counterfactual(clouds, 0, logits),
                                   atol=1e-5)

    def test_generate_shapes_and_determinism(self, server, artifact):
        art, manifest, _ = artifact
        out = art.generate(3, seed=7)
        assert out.shape == (3, manifest['n_out'], 3)
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out, art.generate(3, seed=7))
        np.testing.assert_allclose(out, server.generate(3, seed=7), atol=1e-5)  # the prior's draws on the host
        probs = np.full((2, N_CLASSES), 1.0 / N_CLASSES, np.float32)
        np.testing.assert_allclose(art.generate(2, probs=probs, seed=3), server.generate(2, probs=probs, seed=3),
                                   atol=1e-5)
        np.testing.assert_allclose(art.generate(5, z1_bias=0.5, seed=1), server.generate(5, z1_bias=0.5, seed=1),
                                   atol=1e-5)  # two chunks

    def test_wrong_platform_rejected(self, server, artifact, tmp_path):
        _, _, path = artifact
        with pytest.raises(ValueError, match='exported for'):
            load_artifact(path, platform='rocm')
        with pytest.raises(ValueError, match=r"can export for \['cpu'\]"):
            export_server(server, tmp_path, N_IN, N_CLASSES, platforms=['tpu'])
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match='can export for'):
                export_server(server, tmp_path, N_IN, N_CLASSES, platforms=['cuda'])

    def test_loader_needs_no_model_code(self, server, artifact):
        """A fresh process loads the artifact and serves it with the model
        code, the configuration and the server never imported."""
        _, _, path = artifact
        clouds = _clouds(3, seed=5)
        np.save(path.parent / 'clouds.npy', clouds)
        code = (
            'import sys, json, numpy as np\n'
            'from pccf_torch.export import load_artifact\n'
            f'art = load_artifact({str(path)!r})\n'
            f'clouds = np.load({str(path.parent / "clouds.npy")!r})\n'
            'np.save(sys.argv[1], art.counterfactual(clouds, 1, sampling_seed=2))\n'
            'print(json.dumps(sorted(m for m in sys.modules if m.startswith("pccf"))))\n'
        )
        out_file = path.parent / 'cf.npy'
        env = {**os.environ, 'PYTHONPATH': ROOT}
        proc = subprocess.run([sys.executable, '-c', code, str(out_file)], capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        for name in ('pccf_torch.models', 'pccf_torch.nn', 'pccf_torch.serve', 'pccf_torch.config',
                     'pccf_torch.compose'):
            assert name not in loaded, name
        assert not [m for m in loaded if m == 'pccf' or m.startswith('pccf.')]
        np.testing.assert_allclose(np.load(out_file), server.counterfactual(clouds, 1, sampling_seed=2), atol=1e-5)


def test_cast_server_artifact_matches_live_cast_server(tmp_path):
    """A ``cast_bf16`` server exports its bf16 copy: the artifact serves
    what the live cast server serves."""
    srv = CounterfactualServer(*models(seed=3), buckets=(2,), cast_bf16=True)
    manifest = export_server(srv, tmp_path, N_IN, N_CLASSES, include_generate=False)
    assert manifest['cast_bf16'] and set(manifest['endpoints']) == {'counterfactual', 'classify'}
    art = load_artifact(tmp_path)
    clouds = _clouds(3, seed=6)
    np.testing.assert_allclose(art.classify(clouds), srv.classify(clouds), atol=1e-5)
    np.testing.assert_allclose(art.counterfactual(clouds, 1, sampling_seed=4),
                               srv.counterfactual(clouds, 1, sampling_seed=4), atol=1e-5)


# --------------------------------------------------------------- the ops


def _op_cases():
    """Each op's arguments at a small shape: the slice model's packs, the
    clouds and tokens from a seed."""
    vq, _ = models(seed=5)
    vq.eval().prepack()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 32, 3), generator=g)
    feats = torch.randn((2, 32, 8), generator=g)
    idx = library.knn(x, 6)
    wae = vq.w_autoencoder
    cvae_t, layers = library.cvae_tensors(wae.packed)
    tokens = torch.randn((1, 128, 128), generator=g)
    pcgen_t = library.pcgen_tensors(vq.decoder.packed)
    m, w = torch.randn((1, 256, 8), generator=g), torch.randn((1, 512), generator=g)
    xf = x.clone().requires_grad_(True)
    out, fidx, mean = library.graph_filter(x)
    enc = library.stack_tensors(wformer.pack_encoder(wae.encoder.layers), library.ENCODER_KEYS)
    dec = library.stack_tensors(wformer.pack_decoder(wae.decoder.layers), library.DECODER_KEYS)
    return {
        'knn': (x, 6),
        'graph_max_pool': (feats, idx),
        'cvae_cf': (torch.randn((1, 128, 4), generator=g), torch.softmax(torch.randn((1, 2), generator=g), -1),
                    cvae_t, layers, list(wae.packed.heads), False),
        'pcgen_mix': (m, w, pcgen_t, 5.0, 0.0),
        'pcgen_general': (m, w, pcgen_t, 5.0, 0.0),
        'wformer_encoder': (tokens, enc, 2),
        'wformer_decoder': (tokens, torch.randn((1, 128, 128), generator=g), dec, 2),
        'graph_filter': (xf,),
        'graph_filter_backward': (x, fidx, mean, torch.randn(out.shape, generator=g)),
    }


@pytest.fixture(scope='module')
def op_cases():
    return _op_cases()


@pytest.mark.parametrize('name', sorted(library.OPS))
def test_opcheck(name, op_cases):
    """Schema, autograd registration, fake kernel and AOT dispatch of every
    serving op on the CPU (its plain version)."""
    torch.library.opcheck(library.OPS[name], op_cases[name])


def test_every_serving_kernel_is_an_op():
    assert set(library.OPS) == {'knn', 'graph_max_pool', 'cvae_cf', 'pcgen_mix', 'pcgen_general', 'wformer_encoder',
                                'wformer_decoder', 'graph_filter', 'graph_filter_backward'}
    for name in library.OPS:
        assert hasattr(torch.ops.pccf, name)


def test_export_refuses_a_strided_constant(tmp_path):
    """The archive writes a card tensor's elements packed but its strides as
    they were; a constant that is a transposed view is refused, and the
    CVAE pack stores its transposed weights contiguous."""
    from pccf_torch import export

    class Held(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 4)
            self.held = [self.lin.weight.detach().T]  # (3, 4), a view

        def forward(self, x):
            return x @ self.held[0]

    with torch.no_grad():
        ep = torch.export.export(Held(), (torch.ones(2, 3),))
    with pytest.raises(ValueError, match='strided views'):
        export._save(ep, tmp_path / 'held.pt2')
    vq, _ = models(seed=5)
    vq.eval().prepack()
    assert all(t.is_contiguous() for t in library.cvae_tensors(vq.w_autoencoder.packed)[0])


def test_an_op_body_meets_the_same_pack_again():
    """What a CUDA wrapper derives from a pack is kept on the pack object:
    an eager call hands the op body its caller's pack, and a pack built in
    the body (an exported program's) is built once for its tensors."""
    ts = [torch.ones(3), torch.zeros(2)]
    built = []

    def build():
        built.append(object())
        return built[-1]

    mine = object()
    with library.caller_pack(ts, mine):
        assert library.pack_of(list(ts), build) is mine
    assert not built
    assert library.pack_of(ts, build) is library.pack_of(list(ts), build) is built[0]
    library.pack_of([ts[0], ts[1].clone()], build)  # another tensor object
    assert len(built) == 2


def test_pack_round_trips():
    vq, _ = models(seed=5)
    vq.eval().prepack()
    pack = vq.w_autoencoder.packed
    tensors, layers = library.cvae_tensors(pack)
    back = library.cvae_pack(tensors, layers, list(pack.heads), pack.bf16)
    assert all(a is b for a, b in zip(library.cvae_tensors(back)[0], tensors))
    pc = vq.decoder.packed
    assert all(a is b for a, b in zip(library.pcgen_tensors(library.pcgen_pack(library.pcgen_tensors(pc))),
                                      library.pcgen_tensors(pc)))


# ------------------------------------------------------------ entry point


def test_export_config_holds_the_trees_values():
    """``user.export`` (``configs/experiment/user/user_settings.yaml:30-33``)."""
    assert cli.get_config([])[0].user.export == ExportConfig(path=None, platforms=(), include_generate=True)
    got = cli.get_config(['user.export.path=/a/b', 'user.export.platforms=[cuda,cpu]',
                          'user.export.include_generate=false'])[0].user.export
    assert got == ExportConfig(path='/a/b', platforms=('cuda', 'cpu'), include_generate=False)


def test_export_artifact_entry_point(tmp_path, monkeypatch, capsys):
    """``python -m pccf_torch.export_artifact <TINY> user.cpu=true``: the
    models of the experiment's checkpoints exported to
    ``<version_dir>/artifacts/<name>/``, or to ``user.export.path``."""
    from pccf_torch.config import paths
    from pccf_torch.experiment import Experiment
    from pccf_torch.nn.classifier import ClassifierTrainModule
    from pccf_torch.train.checkpoint import Checkpoint

    from tests.test_pipeline import TINY

    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    args = [*TINY, 'user.cpu=true']
    cfg, tree = cli.parse_args(args)
    vq, cls = build_vqvae(cfg), build_classifier(cfg)
    init_from_seed(vq, 0)
    init_from_seed(cls, 1)
    with Experiment(cfg, tree).create_run():
        Checkpoint(cfg.classifier.name).save(ClassifierTrainModule(cls), 1)
        Checkpoint(cfg.autoencoder.name).save(vq, 2)
    manifest = export_artifact.main(args)
    out = paths().version_dir / 'artifacts' / cfg.name
    assert json.loads((out / 'manifest.json').read_text()) == manifest
    assert manifest['platforms'] == ['cpu'] and set(manifest['endpoints']) == {'counterfactual', 'classify', 'generate'}
    assert f"exported 3 modules for ['cpu'] -> {out}" in capsys.readouterr().out
    clouds = np.random.default_rng(0).standard_normal((3, cfg.data.n_input_points, 3)).astype(np.float32)
    live = CounterfactualServer(vq.eval(), cls.eval())
    np.testing.assert_allclose(load_artifact(out).counterfactual(clouds, 1), live.counterfactual(clouds, 1),
                               atol=1e-5)
    elsewhere = tmp_path / 'elsewhere'
    manifest = export_artifact.main([*args, f'user.export.path={elsewhere}', 'user.export.include_generate=false',
                                     'user.export.platforms=[cpu]'])
    assert set(manifest['endpoints']) == {'counterfactual', 'classify'}
    assert (elsewhere / 'manifest.json').exists()

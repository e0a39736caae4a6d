"""The port's dataset readers and the loader's worker processes against the
JAX package's, on the CPU, on small files the tests write themselves (the
dataset files are not in the repository).

ModelNet40: h5 files in the ``modelnet40_hdf5_2048`` layout through
``pccf_torch.data.modelnet.ModelNet40Dataset`` and
``pccf.data.modelnet.ModelNet40Dataset``: clouds, labels and every split
exactly, kNN indices as sets (a differing neighbour must be a distance tie),
the index cache keys (``index_{k}_{points}`` written back and read, the
legacy ``index_{k}`` of the same point count read, of another ignored), the
40-class check, a training and an inference batch against JAX's
``__getitems__``, and the refusals: no ``h5py``, no archive offline.
ShapeNet: a PC15k tree of npy clouds through both ``ShapeNetDatasetFlow``s:
splits, labels and items bit-equal for one seed, with ``resample`` off and
on.  The loader: two worker processes give the batches of none, which equal
JAX's ``DataLoader``'s, over an epoch of each reader (one spawn test).
``download_extract_zip`` against JAX's on a zip served by a patched fetch.
"""

import json
import pathlib
import shutil
import sys
import urllib.request
import zipfile

import h5py
import numpy as np
import pytest
import torch

from pccf.config import get_config_all
from pccf.data.modelnet import ModelNet40Dataset as JaxModelNet
from pccf.data.protocols import Partitions as JaxPartitions
from pccf.data.protocols import Singleton as JaxSingleton
from pccf.data.shapenet import ShapeNetDatasetFlow as JaxShapeNet
from pccf_torch import cli
from pccf_torch.data.modelnet import ModelNet40Dataset
from pccf_torch.data.protocols import Partitions, Singleton
from pccf_torch.data.shapenet import ShapeNetDatasetFlow

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLASSES = (ROOT / 'dataset_metadata' / 'modelnet_classes.txt').read_text().splitlines()
SYNSETS = {v: k for k, v in json.loads((ROOT / 'dataset_metadata' / 'shapenet_PointFlow_classes.json').read_text())
           .items()}
MODELNET = ['data/dataset=modelnet_desk_table', 'data.n_input_points=64', 'data.n_target_points=64',
            'data.n_neighbors=6', 'autoencoder.model.encoder.n_neighbors=6', 'user.seed=3']
SHAPENET = ['data/dataset=shapenet', 'data.n_input_points=64', 'data.n_target_points=64', 'user.seed=3']
SPLITS = ('train', 'val', 'test', 'train_val')


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('ROOT_EXP_DIR', str(tmp_path / 'exp'))
    monkeypatch.setenv('DATASET_DIR', str(tmp_path / 'data'))
    Singleton.reset_all()
    JaxSingleton.reset_all()
    yield tmp_path / 'data'
    Singleton.reset_all()
    JaxSingleton.reset_all()


def write_modelnet(root: pathlib.Path, seed: int = 0, points: int = 96) -> pathlib.Path:
    """Two train files and one test file of clouds of desk, table and two
    other classes, shuffled."""
    folder = root / 'modelnet40_hdf5_2048'
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    labels = [CLASSES.index(c) for c in ('desk', 'table', 'chair', 'sofa')]
    for name, n in (('ply_data_train0.h5', 17), ('ply_data_train1.h5', 12), ('ply_data_test0.h5', 9)):
        with h5py.File(folder / name, 'w') as f:
            f.create_dataset('data', data=rng.standard_normal((n, points, 3)).astype(np.float32))
            f.create_dataset('label', data=rng.choice(labels, (n, 1)).astype(np.uint8))
    return folder


def _sets_agree(x: np.ndarray, got: np.ndarray, want: np.ndarray) -> bool:
    """Neighbour sets equal, or a differing one a tie in float64 distance."""
    same = (np.sort(got, -1) == np.sort(want, -1)).all(-1)
    if same.all():
        return True
    xd = x.astype(np.float64)

    def dists(idx):
        nb = xd[np.arange(x.shape[0])[:, None, None], idx.astype(np.int64)]
        return np.sort(((nb - xd[:, :, None]) ** 2).sum(-1), -1)

    return same.mean() >= 0.999 and np.abs(dists(got) - dists(want)).max() <= 1e-5


def test_modelnet_reader_matches_jax(data_dir):
    folder = write_modelnet(data_dir)
    jcfg = get_config_all(MODELNET)
    cfg, _ = cli.get_config(MODELNET)
    jax_ds, port = JaxModelNet(jcfg), ModelNet40Dataset(cfg)
    for name in SPLITS:
        if name == 'train_val':
            Singleton.reset_all()
            JaxSingleton.reset_all()
            jax_ds, port = JaxModelNet(jcfg), ModelNet40Dataset(cfg)
        want, got = jax_ds.split(getattr(JaxPartitions, name)), port.split(getattr(Partitions, name))
        assert np.array_equal(got.pcd, want.pcd) and np.array_equal(got.labels, want.labels), name
        assert got.pcd.shape[1:] == (64, 3) and set(got.labels.tolist()) <= {0, 1}
        assert got.indices.dtype == want.indices.dtype == np.int16
        assert _sets_agree(got.pcd, got.indices, want.indices), name
        assert (got.indices[..., 0] == np.arange(64)).all()
    n_train = sum(np.isin(h5py.File(folder / f, 'r')['label'][:, 0], [CLASSES.index('desk'), CLASSES.index('table')])
                  .sum() for f in ('ply_data_train0.h5', 'ply_data_train1.h5'))
    assert len(port.split(Partitions.train)) + len(port.split(Partitions.val)) == n_train
    with h5py.File(folder / 'ply_data_train1.h5', 'r') as f:
        assert 'index_6_64' in f and f['index_6_64'].shape == (12, 64, 6)


def test_modelnet_batches_match_jax(data_dir):
    """A training batch (the batch assembler) and an inference batch (the
    clouds and their indices) against JAX's split on the same generator."""
    write_modelnet(data_dir)
    jax_split = JaxModelNet(get_config_all(MODELNET)).split(JaxPartitions.train)
    port = ModelNet40Dataset(cli.get_config(MODELNET)[0]).split(Partitions.train)
    ids = [5, 0, 7, 2]
    for split in (jax_split, port):
        split.set_inference(False)
        split.rng = np.random.default_rng((3, 1, 0))
    want = jax_split.__getitems__(ids)
    inputs, targets = port.__getitems__(ids)
    assert np.array_equal(inputs.cloud.numpy(), np.stack([w[0].cloud for w in want]))
    assert np.array_equal(targets.ref_cloud.numpy(), np.stack([w[1].ref_cloud for w in want]))
    assert targets.label.tolist() == [int(w[1].label) for w in want]
    jax_split.set_inference(True)
    port.set_inference(True)
    want = [jax_split[i] for i in ids]
    inputs, targets = port.__getitems__(ids)
    assert np.array_equal(inputs.cloud.numpy(), np.stack([w[0].cloud for w in want]))
    assert np.array_equal(inputs.indices.numpy(), np.stack([w[0].indices for w in want]))
    assert inputs.indices.dtype == torch.int32 and torch.equal(targets.ref_cloud, inputs.cloud)


def test_modelnet_index_cache_keys(data_dir, monkeypatch):
    """The written ``index_6_64`` is read back without a kNN; a legacy
    ``index_6`` of the same point count is read, one of another count is
    not; the result equals JAX's on the same files."""
    from pccf_torch.data import modelnet

    folder = write_modelnet(data_dir)
    first = ModelNet40Dataset.load_h5(folder, '*train*.h5', 64, 6)
    computes = modelnet.index_k_neighbours
    monkeypatch.setattr(modelnet, 'index_k_neighbours', lambda *a, **k: pytest.fail('recomputed a cached index'))
    again = ModelNet40Dataset.load_h5(folder, '*train*.h5', 64, 6)
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    legacy = np.random.default_rng(1).integers(0, 64, (9, 64, 6)).astype(np.int16)
    with h5py.File(folder / 'ply_data_test0.h5', 'r+') as f:
        f.create_dataset('index_6', data=legacy)
    assert np.array_equal(ModelNet40Dataset.load_h5(folder, '*test*.h5', 64, 6)[1], legacy)
    assert np.array_equal(JaxModelNet.load_h5(folder, '*test*.h5', 64, 6)[1], legacy)
    monkeypatch.setattr(modelnet, 'index_k_neighbours', computes)
    with h5py.File(folder / 'ply_data_test0.h5', 'r+') as f:
        del f['index_6']
        f.create_dataset('index_6', data=legacy[:, :32])
    got = ModelNet40Dataset.load_h5(folder, '*test*.h5', 64, 6)[1]
    assert got.shape == (9, 64, 6) and (got[..., 0] == np.arange(64)).all()
    with h5py.File(folder / 'ply_data_test0.h5', 'r') as f:
        assert np.array_equal(f['index_6_64'][()], got)


def test_modelnet_refusals(data_dir, monkeypatch):
    """The 40-class check; no h5py (before any download); no archive
    offline, with the manual instructions."""
    write_modelnet(data_dir)
    with pytest.raises(ValueError, match='must cover all 40 classes'):
        ModelNet40Dataset(cli.get_config([*MODELNET, 'data.dataset.n_classes=40'])[0])
    with pytest.raises(ValueError, match='not in the dataset'):
        ModelNet40Dataset(cli.get_config([*MODELNET, 'data.dataset.settings.select_classes=[desk,unicorn]'])[0])
    shutil.rmtree(data_dir / 'modelnet40_hdf5_2048')
    fetched = []
    monkeypatch.setattr(urllib.request, 'urlretrieve', lambda url, path: fetched.append(url) or 1 / 0)
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py'):
        ModelNet40Dataset(cli.get_config(MODELNET)[0])
    assert fetched == []
    monkeypatch.delitem(sys.modules, 'h5py')
    with pytest.raises(FileNotFoundError, match='Download it manually and extract to .*modelnet40_hdf5_2048'):
        ModelNet40Dataset(cli.get_config(MODELNET)[0])
    assert fetched == ['https://gaimfs.ugent.be/Public/Dataset/modelnet40_hdf5_2048.zip']


def test_download_extract_zip_matches_jax(tmp_path, monkeypatch):
    from pccf.utils.download import download_extract_zip as jax_download
    from pccf_torch.data.download import download_extract_zip

    archive = tmp_path / 'served.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
        zf.writestr('things/a.txt', 'a')
        zf.writestr('things/sub/b.txt', 'bb')
    monkeypatch.setattr(urllib.request, 'urlretrieve', lambda url, path: shutil.copy(archive, path))
    trees = []
    for fn, sub in ((jax_download, 'jax'), (download_extract_zip, 'port')):
        fn(tmp_path / sub / 'things', 'https://example.invalid/things.zip')
        fn(tmp_path / sub / 'things', 'https://example.invalid/other.zip')  # present: not fetched again
        trees.append(sorted((str(p.relative_to(tmp_path / sub)), p.read_bytes() if p.is_file() else b'')
                            for p in (tmp_path / sub).rglob('*')))
    assert trees[0] == trees[1] and ('things/sub/b.txt', b'bb') in trees[1]


def write_shapenet(root: pathlib.Path, points: int = 300) -> None:
    """bench and sofa (the selected synsets) and chair, with train / val /
    test clouds; one selected synset has no val folder."""
    rng = np.random.default_rng(4)
    for cls, counts in (('bench', (5, 2, 3)), ('sofa', (4, 0, 2)), ('chair', (2, 1, 1))):
        for split, n in zip(('train', 'val', 'test'), counts):
            if not n:
                continue
            d = root / 'ShapeNetCore.v2.PC15k' / SYNSETS[cls] / split
            d.mkdir(parents=True)
            for i in range(n):
                np.save(d / f'{i:03d}.npy', (rng.standard_normal((points, 3)) * rng.uniform(0.5, 2)).astype(np.float32))


@pytest.mark.parametrize('resample', [False, True])
def test_shapenet_reader_matches_jax(data_dir, resample):
    write_shapenet(data_dir)
    args = [*SHAPENET, f'data.resample={str(resample).lower()}', 'data.rotate=true', 'data.translate=true']
    jax_ds, port = JaxShapeNet(get_config_all(args)), ShapeNetDatasetFlow(cli.get_config(args)[0])
    assert port.synset_ranks == jax_ds.synset_ranks == {SYNSETS['bench']: 0, SYNSETS['sofa']: 1}
    for name in SPLITS:
        want, got = jax_ds.split(getattr(JaxPartitions, name)), port.split(getattr(Partitions, name))
        assert np.array_equal(got.clouds, want.clouds) and np.array_equal(got.labels, want.labels), name
        ids = list(range(len(got)))[::-1]
        got.rng, want.rng = np.random.default_rng((3, 2, 1)), np.random.default_rng((3, 2, 1))
        items = [want[i] for i in ids]
        inputs, targets = got.__getitems__(ids)
        assert np.array_equal(inputs.cloud.numpy(), np.stack([w[0].cloud for w in items])), name
        assert np.array_equal(targets.ref_cloud.numpy(), np.stack([w[1].ref_cloud for w in items])), name
        assert targets.label.tolist() == [int(w[1].label) for w in items]
        assert torch.equal(targets.ref_cloud, inputs.cloud) != resample
    assert len(port.split(Partitions.train_val)) == 11 and len(port.split(Partitions.val)) == 2


def test_shapenet_refusals(data_dir):
    with pytest.raises(FileNotFoundError, match='ShapeNet PC15k not found'):
        ShapeNetDatasetFlow(cli.get_config(SHAPENET)[0])
    write_shapenet(data_dir)
    with pytest.raises(ValueError, match='none of the selected classes'):
        ShapeNetDatasetFlow(cli.get_config([*SHAPENET, 'data.dataset.settings.select_classes=[lamp]'])[0])


def test_worker_processes_give_the_batches_of_none(data_dir):
    """An epoch of each reader's training split through two spawn workers,
    bit-equal to the in-process batches and to JAX's ``DataLoader``; the
    pool ends with ``close``."""
    from pccf.train.loader import DataLoader
    from pccf_torch.train.runners import Loader

    write_shapenet(data_dir)
    write_modelnet(data_dir)
    for args, port_cls, jax_cls in (([*SHAPENET, 'data.resample=true'], ShapeNetDatasetFlow, JaxShapeNet),
                                    (MODELNET, ModelNet40Dataset, JaxModelNet)):
        split = port_cls(cli.get_config(args)[0]).split(Partitions.train)
        jax_split = jax_cls(get_config_all(args)).split(JaxPartitions.train)
        want = list(DataLoader(jax_split, 2, seed=3).epoch_iterator(1, prefetch=0))
        none = list(Loader(split, 2, seed=3).epoch_iterator(1))
        workers = Loader(split, 2, seed=3, n_workers=2)
        try:
            got = list(workers.epoch_iterator(1))
            assert workers._pool is not None and len(workers._pool._processes) == 2
        finally:
            workers.close()
        assert workers._pool is None and len(got) == len(none) == len(want) == len(split) // 2
        for (gi, gt), (ni, nt), (wi, wt) in zip(got, none, want):
            for a, b, c in ((gi.cloud, ni.cloud, wi.cloud), (gt.ref_cloud, nt.ref_cloud, wt.ref_cloud),
                            (gt.label, nt.label, wt.label)):
                assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))

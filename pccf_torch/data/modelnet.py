"""ModelNet40 (``pccf/data/modelnet.py``): the h5 reader
:class:`ModelNet40Dataset` and the split :class:`ModelNet40Split`, whose
item path the synthetic dataset's splits inherit.

The reader loads ``modelnet40_hdf5_2048/*{train,test}*.h5`` under the
dataset directory (``DATASET_DIR``; the archive is fetched where it is
missing, and offline that raises ``FileNotFoundError`` with the manual
instructions), keeps the selected classes, relabels them in the order of
``select_classes``, and gives train, val (every 6th training cloud counted
from the end), train_val and test.  Each file's kNN indices are computed on
the run's device (the kNN kernel on the card) and cached back into the
file, as JAX's reader does.  ``h5py`` is imported when the reader is built:
where it is missing the reader raises an ``ImportError`` that names it.

A batch is a pair of stacked tensors on the run's device, made in two
halves: :meth:`ModelNet40Split.host_batch` builds host arrays (what a
loader worker process runs) and :meth:`ModelNet40Split.upload` moves them
to the device (in the main process).  Training batches come from the batch
assembler (:mod:`pccf_torch.data.sampler`: resample, normalise, jitter, the
shared rotation and scale and translation), seeded from the split's numpy
generator, which the loader seeds anew by ``(seed, epoch, batch)``;
inference items are the stored clouds with their precomputed neighbour
indices.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Any, Sequence

import numpy as np
import torch

from pccf_torch.config import paths
from pccf_torch.data import sampler
from pccf_torch.data.augmentations import augment_clouds, jitter_cloud
from pccf_torch.data.download import download_extract_zip
from pccf_torch.data.protocols import Partitions, PointCloudDataset, SplitCreator
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.kernels import api

logger = logging.getLogger('pccf_torch')

MODELNET_URL = 'https://gaimfs.ugent.be/Public/Dataset/modelnet40_hdf5_2048.zip'


def index_k_neighbours(pcs: np.ndarray, k: int, device: torch.device, chunk: int = 64) -> np.ndarray:
    """The ``k`` nearest neighbours (self first) of every point of every
    cloud ``(N, P, 3)``, in chunks of 64 clouds on ``device`` (the kNN kernel
    on the card), as ``(N, P, k)`` int32 (``modelnet.py:29-43``)."""
    out = [api.knn(torch.from_numpy(pcs[i: i + chunk]).to(device), k).cpu().numpy()
           for i in range(0, pcs.shape[0], chunk)]
    return np.concatenate(out).astype(np.int32)


def import_h5py():
    """``h5py``, or an ``ImportError`` that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError('the ModelNet40 reader needs h5py to read modelnet40_hdf5_2048/*.h5, and h5py does not '
                          'import here') from e
    return h5py


def upload_batch(host: dict[str, np.ndarray | None], device: torch.device) -> tuple[Inputs, Targets]:
    """A reader's host batch (``cloud``, ``ref_cloud``, ``indices``,
    ``label``; a reference or indices may be None) on ``device``: to the card
    from pinned memory, without waiting for the work queued before it; the
    reference is the input cloud where it has none of its own."""
    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if device.type == 'cuda' else t

    cloud = put(host['cloud'])
    ref = cloud if host['ref_cloud'] is None else put(host['ref_cloud'])
    idx = None if host['indices'] is None else put(host['indices'])
    return Inputs(cloud, indices=idx), Targets(ref_cloud=ref, label=put(host['label']))


class ModelNet40Split(PointCloudDataset):
    """One partition: clouds ``pcd (N, P, 3)``, neighbour ``indices`` (or
    None), ``labels (N,)``, on the run's ``device``."""

    def __init__(self, pcd, indices, labels, cfg_data, seed: int = 0, device: torch.device | str = 'cpu') -> None:
        self.pcd = np.ascontiguousarray(pcd, np.float32)
        self.indices = indices
        self.labels = np.asarray(labels, np.int64)
        self.input_points = cfg_data.n_input_points
        self.resample = cfg_data.resample
        self.augment = augment_clouds(cfg_data)
        self.jitter = jitter_cloud(cfg_data)
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.device = torch.device(device)

    def __len__(self) -> int:
        return self.pcd.shape[0]

    def __getitems__(self, idx_list: Sequence[int]) -> tuple[Inputs, Targets]:
        """A batch: from the assembler in training, the stacked items in inference."""
        return self.upload(self.host_batch(idx_list))

    def host_batch(self, idx_list: Sequence[int]) -> dict[str, np.ndarray | None]:
        """The batch as host arrays, ``cloud``, ``ref_cloud``, ``indices``
        and ``label``; no device is touched (the compiled assembler is host
        code)."""
        labels = self.labels[list(idx_list)]
        if not self.inference:
            cloud, ref = sampler.assemble_batch_aug(
                self.device, self.pcd, np.asarray(idx_list, np.int64), self.input_points,
                seed=int(self.rng.integers(2**62)), jitter_sigma=self.jitter.sigma or 0.0,
                jitter_clip=self.jitter.clip or 0.0, resample=self.resample, rotate=self.augment.rotation,
                translate=self.augment.translation_and_scale)
            return {'cloud': cloud, 'ref_cloud': ref, 'indices': None, 'label': labels}
        items = [self.item(int(i)) for i in idx_list]
        cloud = np.stack([c for c, _ in items])
        idx = None if items[0][1] is None else np.stack([i for _, i in items])
        return {'cloud': cloud, 'ref_cloud': None, 'indices': idx, 'label': labels}

    def upload(self, host: dict[str, np.ndarray | None]) -> tuple[Inputs, Targets]:
        return upload_batch(host, self.device)

    def item(self, index: int) -> tuple[np.ndarray, np.ndarray | None]:
        """An inference item: the stored cloud and its neighbour indices."""
        return self.pcd[index], None if self.indices is None else self.indices[index].astype(np.int32)


class ModelNet40Dataset(SplitCreator):
    """The modelnet40_hdf5_2048 archive's selected classes and their splits
    (``modelnet.py:112-204``), on the run's ``device``."""

    def __init__(self, cfg, device: torch.device | str = 'cpu') -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        data, where = cfg.data, paths()
        self.classes = (where.metadata_dir / 'modelnet_classes.txt').read_text().splitlines()
        selected = list(data.setting('select_classes'))
        try:
            selected_labels = [self.classes.index(c) for c in selected]
        except ValueError as ve:
            raise ValueError(f'One of classes in {selected} not in the dataset') from ve
        label_map = {old: new for new, old in enumerate(selected_labels)}
        if data.n_classes == 40:
            # the 40-class path keeps every sample and still relabels through
            # label_map, so the selection must cover all 40 classes
            missing = sorted(set(range(len(self.classes))) - set(selected_labels))
            if missing:
                raise ValueError(f'dataset.n_classes=40 keeps all samples, so select_classes must cover all 40 '
                                 f'classes; missing: {[self.classes[i] for i in missing]}')
        import_h5py()
        self.modelnet_path = where.data_dir / 'modelnet40_hdf5_2048'
        if not self.modelnet_path.exists():
            download_extract_zip(self.modelnet_path, MODELNET_URL)
        self.pcd: dict[Partitions, Any] = {}
        self.indices: dict[Partitions, Any] = {}
        self.labels: dict[Partitions, Any] = {}
        for split in (Partitions.train, Partitions.test):
            pcd, indices, labels = self.load_h5(self.modelnet_path, f'*{split.name}*.h5', data.n_input_points,
                                                data.n_neighbors, self.device)
            sel = slice(None) if data.n_classes == 40 else np.isin(labels, selected_labels)
            self.pcd[split] = pcd[sel]
            self.indices[split] = indices[sel]
            self.labels[split] = np.vectorize(label_map.get, otypes=[np.int64])(labels[sel])

    def split(self, split: Partitions) -> ModelNet40Split:
        if split == Partitions.train_val:
            if Partitions.val in self.pcd:
                raise ValueError('train dataset has already been split')
            split = Partitions.train
        elif split in (Partitions.train, Partitions.val) and Partitions.val not in self.pcd:
            self._split_train_val()
        return ModelNet40Split(self.pcd[split], self.indices[split], self.labels[split], self.cfg.data,
                               seed=self.cfg.user.seed or 0, device=self.device)

    def _split_train_val(self, val_every: int = 6) -> None:
        """Every ``val_every``-th training cloud counted from the end is val
        (``modelnet.py:174-184``)."""
        n = self.pcd[Partitions.train].shape[0]
        val_mask = np.zeros(n, dtype=bool)
        val_mask[np.arange(n)[::-1][::val_every]] = True
        for new_split, mask in ((Partitions.val, val_mask), (Partitions.train, ~val_mask)):
            self.pcd[new_split] = self.pcd[Partitions.train][mask]
            self.indices[new_split] = self.indices[Partitions.train][mask]
            self.labels[new_split] = self.labels[Partitions.train][mask]

    @staticmethod
    def load_h5(path: pathlib.Path, wild: str, input_points: int, k: int,
                device: torch.device | str = 'cpu') -> tuple[Any, Any, Any]:
        """Clouds cut to ``input_points``, their kNN indices (int16) and
        labels from the h5 files matching ``wild``, in name order
        (``modelnet.py:186-230``).  Files open read-only; indices cached
        under ``index_{k}_{input_points}`` (or the legacy ``index_{k}`` of
        the same point count) are read, others computed on ``device`` and
        written back where the file can be opened for writing."""
        h5py = import_h5py()
        pcd_list, idx_list, label_list = [], [], []
        for h5_name in sorted(pathlib.Path(path).glob(wild)):
            with h5py.File(h5_name, 'r') as f:
                logger.info('Load: %s', h5_name)
                pcs = np.asarray(f['data'])[:, :input_points, :].astype('float32')
                labels = np.asarray(f['label']).astype('int64')
                index_key, legacy_key = f'index_{k}_{input_points}', f'index_{k}'
                index = None
                if index_key in f:
                    index = np.asarray(f[index_key]).astype(np.int16)
                elif legacy_key in f and f[legacy_key].shape[1] == pcs.shape[1]:
                    index = np.asarray(f[legacy_key]).astype(np.int16)
            if index is None:
                index = index_k_neighbours(pcs, k, torch.device(device)).astype(np.int16)
                try:
                    with h5py.File(h5_name, 'r+') as f:
                        f.create_dataset(index_key, data=index)
                except (OSError, ValueError) as e:  # a read-only directory, a concurrent writer
                    logger.warning('could not cache %s in %s: %s', index_key, h5_name, e)
            pcd_list.append(pcs)
            idx_list.append(index)
            label_list.append(labels)
        if not pcd_list:
            raise FileNotFoundError(f'No h5 files matching {wild} under {path}')
        return np.concatenate(pcd_list), np.concatenate(idx_list), np.concatenate(label_list).ravel()

"""ShapeNet over the PointFlow ``ShapeNetCore.v2.PC15k`` layout
(``pccf/data/shapenet.py``), numpy only.

The tree under the dataset directory (``DATASET_DIR``) is
``ShapeNetCore.v2.PC15k/<synset>/<train|val|test>/<id>.npy``, each file a
cloud of 15000 points; ``dataset_metadata/shapenet_PointFlow_classes.json``
names the synsets, and ``select_classes`` picks them (all 55 when
``n_classes`` is 55).  Clouds are normalised at load and stacked; a label is
the synset's rank among the selected ones.  train_val is train and val.

Every item draws ``n_input_points`` of the cloud's points without
replacement from the split's numpy generator (which the loader seeds anew
by ``(seed, epoch, batch)``), and with ``resample`` a second, disjoint draw
of the same size is the reference cloud; both are augmented together.  A
batch is those items stacked in order (:meth:`ShapenetFlowSplit.host_batch`,
what a loader worker runs) and uploaded to the run's device from pinned
memory (:func:`~pccf_torch.data.modelnet.upload_batch`).
"""

from __future__ import annotations

import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from pccf_torch.config import paths
from pccf_torch.data.augmentations import augment_clouds, normalise
from pccf_torch.data.modelnet import upload_batch
from pccf_torch.data.protocols import Partitions, PointCloudDataset, SplitCreator
from pccf_torch.data.structures import Inputs, Targets

SHAPENET_LINK = 'https://drive.google.com/drive/folders/1G0rf-6HSHoTll6aH7voh-dXj6hCRhSAQ'

# the layout's folders that make each partition
_PARTITION_SOURCES: dict[Partitions, tuple[str, ...]] = {
    Partitions.train: ('train',),
    Partitions.val: ('val',),
    Partitions.test: ('test',),
    Partitions.train_val: ('train', 'val'),
}


class ShapenetFlowSplit(PointCloudDataset):
    """One partition of PC15k clouds, subsampled per item
    (``shapenet.py:36-90``), on the run's ``device``."""

    def __init__(self, paths_: list[pathlib.Path], cfg_data, seed: int = 0,
                 synset_ranks: dict[str, int] | None = None, device: torch.device | str = 'cpu') -> None:
        self.input_points = cfg_data.n_input_points
        self.resample = cfg_data.resample
        self.augment = augment_clouds(cfg_data)
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.device = torch.device(device)
        clouds, synsets = [], []
        for path in paths_:
            cloud = np.asarray(normalise(np.load(path))[0], dtype=np.float32)
            if clouds and cloud.shape != clouds[0].shape:
                raise ValueError(f'ShapeNet cloud {path} has shape {cloud.shape}, expected {clouds[0].shape} (all '
                                 f'clouds in a split must match to stack)')
            clouds.append(cloud)
            synsets.append(path.parent.parent.name)
        self.clouds = np.stack(clouds) if clouds else np.zeros((0, 0, 3), np.float32)
        # the rank among the dataset's selected synsets, so that a split
        # missing one of them keeps the others' labels
        rank = synset_ranks or {s: i for i, s in enumerate(sorted(set(synsets)))}
        self.labels = np.fromiter((rank[s] for s in synsets), dtype=np.int64, count=len(synsets))

    def __len__(self) -> int:
        return int(self.clouds.shape[0])

    def __getitems__(self, idx_list: Sequence[int]) -> tuple[Inputs, Targets]:
        return self.upload(self.host_batch(idx_list))

    def host_batch(self, idx_list: Sequence[int]) -> dict[str, np.ndarray | None]:
        """The items of ``idx_list`` drawn in order from the one generator
        (``shapenet.py:79-90``), stacked: ``cloud``, ``ref_cloud`` (None
        without ``resample``), ``label``."""
        n = self.input_points
        clouds, refs = [], []
        for index in idx_list:
            cloud = self.clouds[index]
            picks = self.rng.choice(cloud.shape[0], size=2 * n if self.resample else n, replace=False)
            if self.resample:
                inp, ref = self.augment(self.rng, [cloud[picks[:n]], cloud[picks[n:]]])
            else:
                (inp,) = self.augment(self.rng, [cloud[picks]])
                ref = inp
            clouds.append(inp)
            refs.append(ref)
        return {'cloud': np.stack(clouds), 'ref_cloud': np.stack(refs) if self.resample else None, 'indices': None,
                'label': self.labels[list(idx_list)]}

    def upload(self, host: dict[str, np.ndarray | None]) -> tuple[Inputs, Targets]:
        return upload_batch(host, self.device)


class ShapeNetDatasetFlow(SplitCreator):
    """The split creator of ``data/dataset=shapenet``: walks the PC15k tree
    once (``shapenet.py:93-133``)."""

    def __init__(self, cfg, device: torch.device | str = 'cpu') -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        where = paths()
        synset_to_name: dict[str, str] = json.loads(
            (where.metadata_dir / 'shapenet_PointFlow_classes.json').read_text())
        self.shapenet_path = where.data_dir / 'ShapeNetCore.v2.PC15k'
        if not self.shapenet_path.exists():
            raise FileNotFoundError(f'ShapeNet PC15k not found at {self.shapenet_path}; download from {SHAPENET_LINK}')
        synset_dirs = sorted(p for p in self.shapenet_path.iterdir() if p.is_dir())
        if cfg.data.n_classes < 55:
            wanted = set(cfg.data.setting('select_classes'))
            synset_dirs = [d for d in synset_dirs if synset_to_name.get(d.name) in wanted]
            if not synset_dirs:
                raise ValueError(f'none of the selected classes {sorted(wanted)} exist under {self.shapenet_path}')
        self.synset_ranks = {d.name: i for i, d in enumerate(synset_dirs)}
        self.paths = {part: [f for d in synset_dirs for sub in subs for f in sorted((d / sub).glob('*'))]
                      for part, subs in _PARTITION_SOURCES.items()}

    def split(self, split: Partitions) -> ShapenetFlowSplit:
        return ShapenetFlowSplit(self.paths[split], self.cfg.data, seed=self.cfg.user.seed or 0,
                                 synset_ranks=self.synset_ranks, device=self.device)

"""Dataset getters (``pccf/data/dataset.py``): the split creator that
``data.dataset_name`` names, built once a process on the run's device, and
the (train, eval) pair with the ``final`` switch.  Only the synthetic
dataset is ported; the ModelNet and ShapeNet readers wait for their files
and ``h5py`` (``ROADMAP.md``)."""

from __future__ import annotations

import torch

from pccf_torch.data.protocols import Partitions, PointCloudDataset

NOT_PORTED = ('ModelNet', 'ShapenetFlow')


def get_dataset(cfg, partition: Partitions, device: torch.device | str = 'cpu') -> PointCloudDataset:
    from pccf_torch.data.synthetic import SyntheticDataset

    name = cfg.data.dataset_name
    if name in NOT_PORTED:
        raise NotImplementedError(f'the {name} reader is not ported (it waits for the dataset files and h5py; '
                                  f'ROADMAP.md): run data/dataset=synthetic')
    if name != 'Synthetic':
        raise ValueError(f'unknown dataset {name!r}')
    return SyntheticDataset(cfg, device).split(partition)


def get_datasets(cfg, device: torch.device | str = 'cpu') -> tuple[PointCloudDataset, PointCloudDataset]:
    """``final`` trains on train + val and evaluates on test, else train and val."""
    train = get_dataset(cfg, Partitions.train_val if cfg.final else Partitions.train, device)
    test = get_dataset(cfg, Partitions.test if cfg.final else Partitions.val, device)
    return train, test

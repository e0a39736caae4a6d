"""Dataset protocols (``pccf/data/protocols.py``): the partitions, the split
creators (one instance a class, so the raw data loads once a process) and
the dataset base class with its inference switch."""

from __future__ import annotations

import abc
import enum
from typing import Any


class Partitions(enum.Enum):
    train = enum.auto()
    train_val = enum.auto()
    val = enum.auto()
    test = enum.auto()


_SINGLETON_INSTANCES: dict[type, Any] = {}


class Singleton(type):
    """One instance per class; :meth:`reset_all` forgets them all."""

    def __call__(cls, *args, **kwargs):
        if cls not in _SINGLETON_INSTANCES:
            _SINGLETON_INSTANCES[cls] = super().__call__(*args, **kwargs)
        return _SINGLETON_INSTANCES[cls]

    @classmethod
    def reset_all(mcs) -> None:
        _SINGLETON_INSTANCES.clear()


class AbstractSingleton(Singleton, abc.ABCMeta):
    pass


class PointCloudDataset(abc.ABC):
    """A dataset of ``(Inputs, Targets)`` with an inference switch: the
    loader sets it for evaluation passes and clears it for training."""

    inference: bool = False

    def set_inference(self, inference: bool) -> None:
        self.inference = inference

    @abc.abstractmethod
    def __len__(self) -> int: ...


class SplitCreator(abc.ABC, metaclass=AbstractSingleton):
    """Loads a dataset once and gives its partitions."""

    @abc.abstractmethod
    def split(self, split: Partitions) -> PointCloudDataset: ...

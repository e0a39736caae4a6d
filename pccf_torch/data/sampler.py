"""The training batch assembler: ``csrc/cloud_sampler.cpp`` and its plain
version in numpy (``pccf/native/__init__.py`` ``assemble_batch_aug``).

For every item of a batch: ``n_out`` points drawn with replacement,
normalised to the unit sphere and jittered (clipped Gaussian); the reference
cloud is ``normalise(full cloud)`` at a second draw of points where
``resample``, else the input; then one rotation about y and one per-axis
scale and translation shared by the pair.  The draws come from a
splitmix64-seeded xorshift64 stream per item, seeded from the batch seed,
the item's slot and its id, so a batch is the same on every machine.

Dispatch is by the run's device: a run on the card assembles with the
compiled copy in the kernel library (built with the kernels; a build that
fails raises), a run on the CPU with :func:`plain`, which reproduces the
stream draw for draw and the arithmetic operation for operation.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

M64 = (1 << 64) - 1


class Rng:
    """``Rng`` of ``cloud_sampler.cpp``: splitmix64 seeding, xorshift64 stream."""

    def __init__(self, seed: int) -> None:
        s = (seed + 0x9E3779B97F4A7C15) & M64
        s = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & M64
        s = ((s ^ (s >> 27)) * 0x94D049BB133111EB) & M64
        s ^= s >> 31
        self.s = s or 0x1234567

    def next(self) -> int:
        s = self.s
        s ^= (s << 13) & M64
        s ^= s >> 7
        s ^= (s << 17) & M64
        self.s = s
        return s

    def uniform(self) -> float:
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)

    def below(self, n: int, count: int) -> np.ndarray:
        return np.array([self.next() % n for _ in range(count)], dtype=np.int64)


def _unit_sphere_scale(max_r2: float) -> np.float32:
    return np.float32(1.0 / math.sqrt(max_r2)) if max_r2 > 0 else np.float32(1.0)


def _item(cloud: np.ndarray, n_out: int, seed: int, jitter: bool, sigma: float, clip: float) -> np.ndarray:
    """``process_item``: resample, normalise (the mean summed in double in
    point order, the centring in float), jitter (Box-Muller pairs over the
    flat coordinates)."""
    rng = Rng(seed)
    q = cloud[rng.below(cloud.shape[0], n_out)].copy()
    mean = np.cumsum(q.astype(np.float64), axis=0)[-1] / n_out
    q -= mean.astype(np.float32)
    qd = q.astype(np.float64)
    max_r2 = float(np.max(qd[:, 0] * qd[:, 0] + qd[:, 1] * qd[:, 1] + qd[:, 2] * qd[:, 2]))
    q *= _unit_sphere_scale(max_r2)
    if jitter:
        flat = q.reshape(-1)
        total = flat.size
        noise = np.empty(total + 1, np.float32)
        sig, lim = np.float32(sigma), np.float32(clip)
        for i in range(0, total, 2):
            u1, u2 = rng.uniform(), rng.uniform()
            u1 = max(u1, 1e-300)
            r = math.sqrt(-2.0 * math.log(u1))
            noise[i] = np.float32(r * math.cos(6.283185307179586 * u2))
            noise[i + 1] = np.float32(r * math.sin(6.283185307179586 * u2))
        noise = np.clip(noise[:total] * sig, -lim, lim)
        flat += noise
    return q


def _item_aug(cloud: np.ndarray, n_out: int, seed: int, jitter: bool, sigma: float, clip: float, resample: bool,
              rotate: bool, translate: bool) -> tuple[np.ndarray, np.ndarray]:
    """``process_item_aug``: the input cloud from the item's first draw, the
    reference cloud, then the transforms both share."""
    rng = Rng(seed)
    out = _item(cloud, n_out, rng.next(), jitter, sigma, clip)
    ref = None
    if resample:
        full = cloud.astype(np.float64)
        mean = np.cumsum(full, axis=0)[-1] / cloud.shape[0]
        v = full - mean
        max_r2 = float(np.max(np.cumsum(v * v, axis=1)[:, -1]))
        inv = float(_unit_sphere_scale(max_r2))
        ref = ((full[rng.below(cloud.shape[0], n_out)] - mean) * inv).astype(np.float32)
    both = [out] if ref is None else [out, ref]
    if rotate:
        theta = 2.0 * 3.141592653589793 * rng.uniform()
        c, s = np.float32(math.cos(theta)), np.float32(math.sin(theta))
        for q in both:
            x, z = q[:, 0].copy(), q[:, 2].copy()
            q[:, 0] = x * c + z * s
            q[:, 2] = -x * s + z * c
    if translate:
        sc = np.array([u * 5.0 / 6.0 + 2.0 / 3.0 for u in (rng.uniform() for _ in range(3))], np.float32)
        tr = np.array([u * 0.4 - 0.2 for u in (rng.uniform() for _ in range(3))], np.float32)
        for q in both:
            q *= sc
            q += tr
    return out, (out.copy() if ref is None else ref)


def _item_seeds(seed: int, item_ids: np.ndarray) -> list[int]:
    """``run_over_batch``'s seed of the item in each slot."""
    return [(seed * 0x100000001B3 + b * 0x9E3779B1 + int(i)) & M64 for b, i in enumerate(item_ids)]


def _check(clouds: np.ndarray, item_ids: np.ndarray, n_out: int) -> None:
    if clouds.ndim != 3 or clouds.shape[2] != 3:
        raise ValueError(f'clouds must be (n_items, n_src, 3) float32; got {clouds.shape}')
    if item_ids.ndim != 1:
        raise ValueError(f'item_ids must be 1-D; got shape {item_ids.shape}')
    if clouds.shape[0] <= 0 or clouds.shape[1] <= 0 or n_out <= 0:
        raise ValueError(f'bad batch shapes: clouds {clouds.shape}, item_ids {item_ids.shape}, n_out {n_out}')
    if item_ids.size and (item_ids.min() < 0 or item_ids.max() >= clouds.shape[0]):
        raise ValueError(f'item_ids out of range [0, {clouds.shape[0]}): min={item_ids.min()}, max={item_ids.max()}')


def plain(clouds: np.ndarray, item_ids: np.ndarray, n_out: int, seed: int, jitter_sigma: float = 0.0,
          jitter_clip: float = 0.0, resample: bool = False, rotate: bool = False,
          translate: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """``(cloud, ref)``, each ``(batch, n_out, 3)`` float32, in numpy."""
    clouds = np.ascontiguousarray(clouds, np.float32)
    item_ids = np.ascontiguousarray(item_ids, np.int64)
    _check(clouds, item_ids, n_out)
    jitter = bool(jitter_sigma and jitter_clip)
    pairs = [_item_aug(clouds[i], n_out, s, jitter, jitter_sigma, jitter_clip, resample, rotate, translate)
             for i, s in zip(item_ids, _item_seeds(seed & M64, item_ids))]
    if not pairs:
        return np.empty((0, n_out, 3), np.float32), np.empty((0, n_out, 3), np.float32)
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def compiled(clouds: np.ndarray, item_ids: np.ndarray, n_out: int, seed: int, jitter_sigma: float = 0.0,
             jitter_clip: float = 0.0, resample: bool = False, rotate: bool = False,
             translate: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The same from ``pccf_assemble_batch_aug`` of the kernel library, built
    on first use."""
    from pccf_torch.kernels import _build

    clouds = np.ascontiguousarray(clouds, np.float32)
    item_ids = np.ascontiguousarray(item_ids, np.int64)
    _check(clouds, item_ids, n_out)
    batch = item_ids.shape[0]
    out = np.empty((batch, n_out, 3), np.float32)
    ref = np.empty((batch, n_out, 3), np.float32)
    rc = _build.lib().pccf_assemble_batch_aug(
        clouds.ctypes.data, clouds.shape[0], clouds.shape[1], item_ids.ctypes.data, batch, n_out,
        ctypes.c_uint64(seed & M64), 1 if jitter_sigma and jitter_clip else 0, float(jitter_sigma),
        float(jitter_clip), int(resample), int(rotate), int(translate), out.ctypes.data, ref.ctypes.data)
    if rc:
        raise ValueError(f'pccf_assemble_batch_aug refused clouds {clouds.shape}, item_ids {item_ids.shape} ({rc})')
    return out, ref


def assemble_batch_aug(device: torch.device, *args, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """:func:`compiled` for a run on the card, :func:`plain` for one on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return compiled(*args, **kwargs)
    if device.type == 'cpu':
        return plain(*args, **kwargs)
    raise ValueError(f'no batch assembler for device {device}')

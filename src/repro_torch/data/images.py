"""Synthetic image batches of any H x W (port of ``repro.data.images``).

The HVAE is fully convolutional, so one trained model codes images of any
even size. The 28 x 28 synthetic digits of ``synthetic_mnist`` are
collated to a target shape per axis: a random crop window where the
target is smaller, a random offset in a zero canvas where it is larger.
Every function draws the reference's numpy numbers in the reference's
order, so the arrays are the reference's.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from repro_torch.data import synthetic_mnist


def collate(images: np.ndarray, hw: Tuple[int, int],
            rng: np.random.Generator) -> np.ndarray:
    """Crop or pad a [n, 28, 28] (or [n, 784]) batch to [n, H, W], offsets
    drawn per image (the collation doubles as random translation)."""
    if images.ndim == 2:
        images = images.reshape(-1, synthetic_mnist.H, synthetic_mnist.W)
    n, sh, sw = images.shape
    th, tw = hw
    out = np.zeros((n, th, tw), images.dtype)
    ch, cw = min(sh, th), min(sw, tw)
    src_y = rng.integers(0, sh - ch + 1, n)
    src_x = rng.integers(0, sw - cw + 1, n)
    dst_y = rng.integers(0, th - ch + 1, n)
    dst_x = rng.integers(0, tw - cw + 1, n)
    for i in range(n):
        out[i, dst_y[i]:dst_y[i] + ch, dst_x[i]:dst_x[i] + cw] = \
            images[i, src_y[i]:src_y[i] + ch, src_x[i]:src_x[i] + cw]
    return out


def pad_to_even(images: np.ndarray) -> np.ndarray:
    """Zero-pad [n, H, W] at the bottom and right to even H and W (the one
    shape constraint of the stride-2 HVAE stem)."""
    _, h, w = images.shape
    return np.pad(images, ((0, 0), (0, h % 2), (0, w % 2)))


def load(split: str = "train", n: int = 8000, seed: int = 0,
         hw: Tuple[int, int] = (28, 28),
         binarized: bool = True) -> np.ndarray:
    """Synthetic digits collated to ``hw``: uint8 [n, H, W], binary or
    0..255."""
    imgs, _ = synthetic_mnist.load(split, n, seed)
    if binarized:
        imgs = synthetic_mnist.binarize(imgs, seed)
    salt = {"train": 0x5EED, "test": 0x7E57}[split]
    rng = np.random.default_rng(seed * 7919 + salt)
    return collate(imgs, hw, rng)


def image_batch_fn(images: np.ndarray, batch: int, hw: Tuple[int, int]
                   ) -> Callable[[int, int, int, int],
                                 Dict[str, np.ndarray]]:
    """``(seed, step, shard, nshards) -> {"images": int32 [B/nshards, H,
    W]}``, a pure function of its arguments; crops are drawn anew at
    every step."""
    if images.ndim == 2:
        images = images.reshape(-1, synthetic_mnist.H, synthetic_mnist.W)

    def fn(seed, step, shard, nshards):
        rng = np.random.default_rng((seed * 1_000_003 + step) ^ shard)
        idx = rng.integers(0, len(images), batch // nshards)
        return {"images": collate(images[idx], hw, rng).astype(np.int32)}

    return fn


def shape_schedule(shapes: Sequence[Tuple[int, int]],
                   step: int) -> Tuple[int, int]:
    """Cycle a set of image shapes across steps."""
    return tuple(shapes[step % len(shapes)])

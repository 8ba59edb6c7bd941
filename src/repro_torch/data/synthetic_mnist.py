"""Deterministic synthetic MNIST-like digits: the port's own copy of
``repro/data/synthetic_mnist.py`` (numpy only, identical output), kept
here so that ``repro_torch`` imports nothing of ``repro``.

Digits are rendered procedurally: per-digit stroke polylines -> random
affine jitter -> soft distance-field rasterization -> intensity jitter.
All data is a pure function of the seed.

API mirrors common MNIST loaders:
  load(split, n, seed)            -> uint8 [n, 784] in [0, 255]
  binarize(images, seed)          -> uint8 [n, 784] in {0, 1} (stochastic,
                                     as Salakhutdinov & Murray 2008)
"""

from __future__ import annotations

import numpy as np

H = W = 28
DIM = H * W


def _circle(cx, cy, rx, ry, n=14, a0=0.0, a1=2 * np.pi):
    t = np.linspace(a0, a1, n)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], axis=-1)


def _digit_strokes():
    """List (per digit 0-9) of polylines; each polyline is [P, 2] in the
    unit square (x right, y down)."""
    d = {}
    d[0] = [_circle(0.5, 0.5, 0.21, 0.32)]
    d[1] = [np.array([[0.36, 0.28], [0.54, 0.16], [0.54, 0.84]])]
    d[2] = [np.concatenate([
        _circle(0.5, 0.32, 0.2, 0.17, 7, -np.pi, 0.0),
        np.array([[0.68, 0.38], [0.3, 0.84], [0.72, 0.84]])])]
    d[3] = [np.concatenate([
        _circle(0.47, 0.32, 0.2, 0.16, 7, -np.pi * 0.8, np.pi * 0.5),
        _circle(0.47, 0.67, 0.22, 0.18, 7, -np.pi * 0.5, np.pi * 0.82)])]
    d[4] = [np.array([[0.58, 0.14], [0.27, 0.6], [0.76, 0.6]]),
            np.array([[0.6, 0.34], [0.6, 0.86]])]
    d[5] = [np.concatenate([
        np.array([[0.7, 0.16], [0.33, 0.16], [0.31, 0.48]]),
        _circle(0.48, 0.65, 0.22, 0.19, 8, -np.pi * 0.45, np.pi * 0.75)])]
    d[6] = [np.concatenate([
        np.array([[0.64, 0.14], [0.42, 0.36]]),
        _circle(0.47, 0.65, 0.18, 0.2, 10, np.pi * 0.75,
                np.pi * 0.75 + 2 * np.pi)])]
    d[7] = [np.array([[0.3, 0.16], [0.72, 0.16], [0.44, 0.86]])]
    d[8] = [_circle(0.5, 0.33, 0.16, 0.15),
            _circle(0.5, 0.67, 0.2, 0.17)]
    d[9] = [_circle(0.52, 0.35, 0.17, 0.17),
            np.array([[0.69, 0.38], [0.6, 0.86]])]
    return [d[i] for i in range(10)]


def _pack_segments():
    """Pack all digit strokes into [10, S, 2, 2] segments + mask [10, S]."""
    strokes = _digit_strokes()
    segs, masks = [], []
    max_s = 0
    all_segs = []
    for polys in strokes:
        s = []
        for poly in polys:
            for i in range(len(poly) - 1):
                s.append(np.stack([poly[i], poly[i + 1]]))
        all_segs.append(np.array(s))
        max_s = max(max_s, len(s))
    for s in all_segs:
        pad = max_s - len(s)
        masks.append(np.concatenate([np.ones(len(s)), np.zeros(pad)]))
        if pad:
            s = np.concatenate([s, np.zeros((pad, 2, 2))])
        segs.append(s)
    return np.stack(segs), np.stack(masks).astype(bool)


_SEGS, _SEG_MASK = _pack_segments()


#: images rendered at a time: the distance field of a chunk stays in
#: cache (the draws are made for the whole batch first, in the original
#: order, so the output does not depend on the chunk size)
_CHUNK = 128


def render(labels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Render a batch of digits. labels int[n] -> uint8 [n, 784]."""
    n = len(labels)
    # Pixel-centre coordinates in the unit square.
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([(xs + 0.5) / W, (ys + 0.5) / H], -1).reshape(-1, 2)

    # Per-image random affine (applied to grid coords, i.e. inverse map),
    # stroke width, peak intensity and background noise.
    ang = rng.uniform(-0.18, 0.18, n)
    scale = rng.uniform(0.85, 1.12, (n, 1))
    shear = rng.uniform(-0.12, 0.12, n)
    tx = rng.uniform(-0.07, 0.07, (n, 2))
    width = rng.uniform(0.032, 0.05, (n, 1))
    peak = rng.uniform(0.75, 1.0, (n, 1))
    # Faint sensor noise in the background, like MNIST's greyscale fringe.
    noise = rng.uniform(0, 6, (n, H * W))

    ca, sa = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([ca, -sa], -1),
                    np.stack([sa, ca], -1)], -2)          # [n, 2, 2]
    shm = np.tile(np.eye(2), (n, 1, 1))
    shm[:, 0, 1] = shear
    amat = np.einsum("nij,njk->nik", rot, shm) / scale[..., None]
    centred = grid[None] - 0.5                           # [n, 784, 2]

    out = np.empty((n, H * W), np.uint8)
    for lo in range(0, n, _CHUNK):
        c = slice(lo, lo + _CHUNK)
        coords = np.einsum("nij,npj->npi", amat[c], centred) + 0.5 \
            + tx[c, None]
        segs = _SEGS[labels[c]]        # [m, S, 2, 2]
        mask = _SEG_MASK[labels[c]]    # [m, S]
        # Distance from each pixel to each segment, x and y apart (the
        # two-term sums in the reference's order, x first).
        ax, ay = segs[:, None, :, 0, 0], segs[:, None, :, 0, 1]
        abx = segs[:, None, :, 1, 0] - ax          # [m, 1, S]
        aby = segs[:, None, :, 1, 1] - ay
        px, py = coords[:, :, None, 0], coords[:, :, None, 1]  # [m, 784, 1]
        denom = (abx * abx + aby * aby) + 1e-9
        t = ((px - ax) * abx + (py - ay) * aby) / denom
        t = np.clip(t, 0.0, 1.0)
        dist = np.sqrt((px - (ax + t * abx)) ** 2
                       + (py - (ay + t * aby)) ** 2)  # [m, 784, S]
        dist = np.where(mask[:, None], dist, np.inf).min(-1)

        inten = np.exp(-0.5 * (dist / width[c]) ** 2)
        img = np.clip(inten * peak[c] * 255.0, 0, 255)
        img += noise[c]
        out[c] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def load(split: str = "train", n: int = 10000, seed: int = 0):
    """Deterministic split -> (images uint8 [n, 784], labels int[n])."""
    salt = {"train": 0x5EED, "test": 0x7E57}[split]
    rng = np.random.default_rng(seed * 1000003 + salt)
    labels = rng.integers(0, 10, n)
    return render(labels, rng), labels


def binarize(images: np.ndarray, seed: int = 0) -> np.ndarray:
    """Stochastic binarization (Salakhutdinov & Murray, 2008)."""
    rng = np.random.default_rng(seed + 0xB1A4)
    return (rng.random(images.shape) < images / 255.0).astype(np.uint8)

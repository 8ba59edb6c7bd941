"""Generic-compressor baselines for the Table-1 comparison: the port's
own copy of ``repro/data/baselines.py`` (numpy and the standard library
only, the same rates), kept here so that ``repro_torch`` imports nothing
of ``repro``.

The paper's headline artifact (Table 1) pits BB-ANS bits/dim against
off-the-shelf compressors on the full MNIST set. This module computes
those reference rates on any image batch:

  * ``gzip``/``bz2``/``lzma`` - stdlib, whole-corpus (one stream over
    the concatenated images; binarized corpora are bit-packed first);
  * ``png`` - real per-image PNG via PIL, when PIL is installed;
  * ``png_proxy`` - a dependency-free stand-in for PNG used by the CI
    benchmark: per image, PNG's actual pipeline (scanline filtering -
    Paeth for 8-bit, bit-packing for binary - then one zlib stream)
    plus PNG's fixed 57 bytes of per-file structure (signature + IHDR
    + IDAT framing + IEND). It tracks real PNG within a few percent on
    this corpus and keeps the benchmark rows identical with or without
    PIL.

Used by ``launch/compress.py`` (the Table-1 CLI).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

#: PNG per-file structural bytes: 8 signature + 25 IHDR + 12 IDAT
#: chunk framing + 12 IEND.
PNG_FIXED_BYTES = 57


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = (np.abs(p - x.astype(np.int32)) for x in (a, b, c))
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _filtered_scanlines(img: np.ndarray, binary: bool) -> bytes:
    """One image's IDAT input: filter byte + filtered bytes per row."""
    h, w = img.shape
    if binary:
        rows = [np.packbits(img[y].astype(np.uint8)).tobytes()
                for y in range(h)]
        return b"".join(b"\x00" + r for r in rows)
    out = []
    prev = np.zeros((w,), np.uint8)
    for y in range(h):
        row = img[y].astype(np.uint8)
        left = np.concatenate([[0], row[:-1]]).astype(np.uint8)
        upleft = np.concatenate([[0], prev[:-1]]).astype(np.uint8)
        filt = (row.astype(np.int32)
                - _paeth(left, prev, upleft).astype(np.int32)) % 256
        out.append(b"\x04" + filt.astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_proxy_bytes(img: np.ndarray, binary: bool) -> int:
    """Size of one image as the dependency-free PNG proxy (see module
    docstring).

    Example::

        n = png_proxy_bytes(np.zeros((28, 28), np.uint8), binary=True)
        assert n > PNG_FIXED_BYTES
    """
    raw = _filtered_scanlines(np.asarray(img), binary)
    return len(zlib.compress(raw, 9)) + PNG_FIXED_BYTES


def png_bytes(img: np.ndarray, binary: bool) -> Optional[int]:
    """Size of one image as a real PNG (PIL); None when PIL is absent."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io
    arr = np.asarray(img, np.uint8)
    im = Image.fromarray(arr * 255 if binary else arr)
    if binary:
        im = im.convert("1")
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=True)
    return buf.getbuffer().nbytes


def baseline_rates(images: np.ndarray, binary: bool,
                   hw: Tuple[int, int] = (28, 28),
                   with_png: bool = False,
                   try_real_png: bool = True) -> Dict[str, float]:
    """bits/dim of the generic compressors on an image batch.

    ``images`` is uint8 ``[n, H*W]`` (or ``[n, H, W]``); binarized
    corpora are bit-packed before the corpus-level compressors.
    ``with_png=True`` adds the per-image ``png_proxy`` row and, when
    PIL is installed, the real ``png`` row - pass
    ``try_real_png=False`` to skip the real-PNG pass (the CI bench
    does: its rows must be identical with or without PIL, so encoding
    every image twice would be wasted work).

    Example::

        rates = baseline_rates(imgs, binary=True, with_png=True)
        assert set(rates) >= {"gzip", "bz2", "lzma", "png_proxy"}
    """
    images = np.asarray(images)
    n_dims = images.size
    payload = np.packbits(images.astype(np.uint8)).tobytes() if binary \
        else images.astype(np.uint8).tobytes()
    out = {
        "gzip": len(gzip.compress(payload, 9)) * 8 / n_dims,
        "bz2": len(bz2.compress(payload, 9)) * 8 / n_dims,
        "lzma": len(lzma.compress(payload, preset=6)) * 8 / n_dims,
    }
    try:
        import zstandard as zstd
        out["zstd"] = len(zstd.ZstdCompressor(level=19).compress(payload)
                          ) * 8 / n_dims
    except ImportError:
        pass
    if with_png:
        imgs2d = images.reshape(-1, *hw)
        out["png_proxy"] = sum(
            png_proxy_bytes(im, binary) for im in imgs2d) * 8 / n_dims
        if try_real_png:
            real = [png_bytes(im, binary) for im in imgs2d]
            if all(r is not None for r in real):
                out["png"] = sum(real) * 8 / n_dims
    return out

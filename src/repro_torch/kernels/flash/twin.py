"""The flash-attention forward in plain PyTorch, tile for tile as the
CUDA kernels walk it: the kernels' CPU path and what they are held to on
the card.

For each tile of ``BLOCK_Q`` queries it visits only the key tiles of
``block_k(D)`` that the causal and window limits leave (``kv_tiles``), and
updates the online softmax ``(m, l, acc)``, in float32, once a key tile,
as the bfloat16 tensor-core kernel does (and the Pallas kernel at its
default ``block_k``, ``BLOCK_K``, up to D 128): a bfloat16 ``p`` is
rounded against the same running max on both. The float32 kernel walks
other tiles (``simt_tiles``), which ``tiles`` gives this version too;
float32 ``p`` is not rounded, so the tiles change only the float32
rounding. Scores are ``q . k * D^-0.5`` summed in float32 (on the card,
bfloat16 scores are summed by the tensor cores, as the kernel sums them)
and held in log2 units; a masked score is -1e30 (not -inf, as the Pallas
kernel sets it), ``p`` is cast to v's dtype before ``p . v``, and the
output is ``acc / max(l, 1e-30)`` in q's dtype. GQA: query head ``h`` of
``[BH, Sq, D]`` reads key/value head ``h // G`` of ``[BH // G, Sk, D]``;
nothing is repeated.

A row with no key left by its masks has no defined output (the kernel
and this version average the values of the tiles they visited); causal
attention always leaves the query's own key, and the model asks for no
other case.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK_Q = 128
BLOCK_K = 128
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def block_k(d: int) -> int:
    """Keys a tile, and a softmax update, at head dim ``d``: ``BLOCK_K``
    up to 128, 64 above (the tensor-core kernel's ``key_tile``: at 192
    padded columns two stages of 128-key tiles overflow its shared
    memory)."""
    return BLOCK_K if d <= 128 else 64


#: 128-query blocks from which the float32 kernel takes 8 query rows a
#: thread (up to D 64): twice the H100's 132 multiprocessors
SIMT_WIDE_GRID = 2 * 132


def simt_tiles(d: int, bh: int, sq: int) -> Tuple[int, int]:
    """(queries, keys) a tile of the float32 kernel (``csrc/flash_fwd.cu``)
    on q [bh, sq, d]: 128 queries up to D 64 when ``bh`` x ceil(sq / 128)
    blocks of them fill the card twice over (``SIMT_WIDE_GRID``), else 64;
    64 keys up to D 160, 32 above (two stages of 64 would overflow its
    shared memory)."""
    wide = d <= 64 and bh * -(-sq // 128) >= SIMT_WIDE_GRID
    return 128 if wide else 64, 64 if d <= 160 else 32


def kv_tiles(q0: int, q1: int, sk: int, causal: bool, window: int,
             bk: int = BLOCK_K) -> Tuple[int, int]:
    """The key tiles ``[lo, hi)`` of ``bk`` keys that queries ``[q0,
    q1)`` may attend to: up to the last query when causal, from ``q0 -
    window + 1`` when ``window > 0``."""
    end = min(sk, q1) if causal else sk
    start = max(0, q0 - window + 1) if window > 0 else 0
    return start // bk, -(-end // bk)


def _scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """q . k summed in float32: qb [H, G, Q, D], kb [H, K, D] -> [H, G,
    Q, K]. bfloat16 on the card goes through the tensor cores (bf16
    products, float32 sums), as the wgmma kernel and the Pallas kernel's
    MXU dot form them: a float32 SGEMM sums in another order, and a p
    one ulp off then rounds to another bfloat16."""
    h, g, nq, d = qb.shape
    if qb.is_cuda and qb.dtype == torch.bfloat16:
        s = torch.bmm(qb.reshape(h, g * nq, d), kb.transpose(1, 2),
                      out_dtype=torch.float32)
        return s.reshape(h, g, nq, kb.shape[1])
    return torch.einsum("hgqd,hkd->hgqk", qb.float(), kb.float())


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              head_dim: Optional[int] = None,
              tiles: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """q [BH, Sq, D]; k/v [BH // G, Sk, D] (float32 or bfloat16) -> out
    [BH, Sq, D] in q's dtype. ``window <= 0`` disables the window.
    ``head_dim`` (default D) sets the scale ``head_dim^-0.5``, as the
    kernels take it for zero-padded heads. ``tiles`` (queries, keys a
    tile; default ``(BLOCK_Q, block_k(D))``) sets where the online softmax
    updates. Scores are kept in log2 units
    (times log2(e)) and exponentiated with exp2, as the bfloat16 kernel
    does, so that its p rounds as this one's."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    bq, bk = tiles or (BLOCK_Q, block_k(d))
    scale = (head_dim or d) ** -0.5 * LOG2E
    qg = q.reshape(bkv, g, sq, d)
    vf = v.float()
    out = torch.empty((bkv, g, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        q_ids = torch.arange(q0, q1, device=q.device)[:, None]
        qb = qg[:, :, q0:q1]
        m = torch.full(qb.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, device=q.device)
        lo, hi = kv_tiles(q0, q1, sk, causal, window, bk)
        for k0 in range(lo * bk, min(hi * bk, sk), bk):
            k1 = min(k0 + bk, sk)
            k_ids = torch.arange(k0, k1, device=q.device)[None, :]
            s = _scores(qb, k[:, k0:k1]) * scale
            valid = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                               device=q.device)
            if causal:
                valid &= k_ids <= q_ids
            if window > 0:
                valid &= k_ids > q_ids - window
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("hgqk,hkd->hgqd", p.to(v.dtype).float(),
                              vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]
                            ).to(q.dtype)
    return out.reshape(bh, sq, d)

"""The flash-attention forward in plain PyTorch, tile for tile as the
CUDA kernel walks it: the kernel's CPU path and what it is held to on
the card.

For each tile of ``BLOCK_Q`` queries it visits only the key tiles of
``BLOCK_K`` that the causal and window limits leave (``kv_tiles``), and
updates the online softmax ``(m, l, acc)``, in float32, once every
``SUB`` keys, as the kernel does: a bfloat16 ``p`` is rounded against the
same running max on both sides, so the two agree to float32 rounding
before the output's own rounding. Scores are
``q . k * D^-0.5`` in float32, a masked score is -1e30 (not -inf, as the
Pallas kernel sets it), ``p`` is cast to v's dtype before ``p . v``, and
the output is ``acc / max(l, 1e-30)`` in q's dtype. GQA: query head
``h`` of ``[BH, Sq, D]`` reads key/value head ``h // G`` of
``[BH // G, Sk, D]``; nothing is repeated.

A row with no key left by its masks has no defined output (the kernel
and this version average the values of the tiles they visited); causal
attention always leaves the query's own key, and the model asks for no
other case.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK_Q = 128
BLOCK_K = 64
SUB = 16
NEG_INF = -1e30


def kv_tiles(q0: int, q1: int, sk: int, causal: bool, window: int
             ) -> Tuple[int, int]:
    """The key tiles ``[lo, hi)`` that queries ``[q0, q1)`` may attend
    to: up to the last query when causal, from ``q0 - window + 1`` when
    ``window > 0``."""
    end = min(sk, q1) if causal else sk
    start = max(0, q0 - window + 1) if window > 0 else 0
    return start // BLOCK_K, -(-end // BLOCK_K)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D]; k/v [BH // G, Sk, D] (float32 or bfloat16) -> out
    [BH, Sq, D] in q's dtype. ``window <= 0`` disables the window."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    scale = d ** -0.5
    qg = q.reshape(bkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((bkv, g, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, sq)
        q_ids = torch.arange(q0, q1, device=q.device)[:, None]
        qb = qg[:, :, q0:q1]
        m = torch.full(qb.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, device=q.device)
        lo, hi = kv_tiles(q0, q1, sk, causal, window)
        for k0 in range(lo * BLOCK_K, min(hi * BLOCK_K, sk), SUB):
            k1 = min(k0 + SUB, sk)
            k_ids = torch.arange(k0, k1, device=q.device)[None, :]
            s = torch.einsum("hgqd,hkd->hgqk", qb, kf[:, k0:k1]) * scale
            valid = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                               device=q.device)
            if causal:
                valid &= k_ids <= q_ids
            if window > 0:
                valid &= k_ids > q_ids - window
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("hgqk,hkd->hgqd", p.to(v.dtype).float(),
                              vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]
                            ).to(q.dtype)
    return out.reshape(bh, sq, d)

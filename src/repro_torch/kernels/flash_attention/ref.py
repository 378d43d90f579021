"""Plain torch chunked flash attention (online softmax): the oracle for
the CUDA kernel and the path tensors on the CPU take.

Memory O(S_q · block_k) instead of O(S_q · S_k): a loop over KV blocks
carries the running (max, sum, acc) per query, numerically the full
softmax attention up to the order of float additions.

Supports GQA head broadcasting, causal masking with a query offset
(decode against a long cache), and sliding windows (a Python int;
``<= 0`` or None means full causal).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention_ref(q, k, v, *, q_offset: int = 0,
                        window: int | None = None, block_k: int = 512,
                        scale: float | None = None):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    q_offset: absolute position of q[0] (queries are contiguous).
    window: None or an int; <= 0 means full causal.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    nb = -(-sk // block_k)
    pad = nb * block_k - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device

    qh = (q.float() * scale).reshape(b, sq, hkv, g, d)
    q_pos = q_offset + torch.arange(sq, device=dev)
    kb = k.reshape(b, nb, block_k, hkv, d).float()
    vb = v.reshape(b, nb, block_k, hkv, d).float()

    m = torch.full((b, sq, hkv, g), -torch.inf, device=dev)
    s = torch.zeros((b, sq, hkv, g), device=dev)
    acc = torch.zeros((b, sq, hkv, g, d), device=dev)
    for i in range(nb):
        k_pos = i * block_k + torch.arange(block_k, device=dev)
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qh, kb[:, i])
        mask = q_pos[:, None] >= k_pos[None, :]              # (Sq, L)
        mask &= k_pos[None, :] < sk                          # padding
        if window is not None and window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        mask = mask[None, :, None, None, :]
        logits = torch.where(mask, logits, -torch.inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p, vb[:, i])
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)

"""Plain torch chunked flash attention (online softmax): the oracle for
the CUDA kernel and the path tensors on the CPU take.

Memory O(S_q · block_k) instead of O(S_q · S_k): a loop over KV blocks
carries the running (max, sum, acc) per query, numerically the full
softmax attention up to the order of float additions.

Supports GQA head broadcasting, causal masking with a query offset
(decode against a long cache), and sliding windows (a Python int;
``<= 0`` or None means full causal).

``return_lse=True`` also returns each row's log-sum-exp of its scaled
logits, (B, Hq, Sq) float32 (-inf for a row that sees no key): what the
backward needs to recompute the softmax.  `flash_attention_bwd_ref` is
that backward written out, from q, k, v, the output o, the LSE and dO:
per key block P = exp(S scale - LSE), dP = dO V^T, dS = P (dP - delta)
with delta = rowsum(dO o), then dV = P^T dO, dK = dS^T Q scale and dQ =
dS K scale, in float32, GQA's heads summed into their key head.
`flash_bwd_dq_ref` and `flash_bwd_dkdv_ref` compute its two halves alone,
as the two backward kernels do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention_ref(q, k, v, *, q_offset: int = 0,
                        window: int | None = None, block_k: int = 512,
                        scale: float | None = None, return_lse: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), and
    with ``return_lse`` the rows' LSE (B, Hq, Sq) float32.

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
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(s > 0, m + torch.log(s), -torch.inf)
    return out, lse.reshape(b, sq, hq).transpose(1, 2).contiguous()


def _visible(q_pos, k_pos, sk: int, window):
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < sk)
    if window is not None and window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def _bwd(q, k, v, o, lse, do, *, q_offset, window, block_k, scale, dq_part,
         dkdv_part):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qh = (q.float() * scale).reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    delta = (dof * o.float().reshape(b, sq, hkv, g, d)).sum(-1)
    lse = lse.float().transpose(1, 2).reshape(b, sq, hkv, g)
    q_pos = q_offset + torch.arange(sq, device=dev)
    dq = torch.zeros((b, sq, hkv, g, d), device=dev)
    dk = torch.zeros((b, sk, hkv, d), device=dev)
    dv = torch.zeros((b, sk, hkv, d), device=dev)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        mask = _visible(q_pos, torch.arange(k0, k1, device=dev), sk,
                        window)[None, :, None, None, :]
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qh, kb)
        p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vb)
        ds = p * (dp - delta[..., None])
        if dkdv_part:
            dv[:, k0:k1] = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
            dk[:, k0:k1] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qh)
        if dq_part:
            dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kb) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, q_offset: int = 0,
                            window: int | None = None, block_k: int = 512,
                            scale: float | None = None):
    """The gradients (dq, dk, dv) of `flash_attention_ref` given its
    output ``o``, its LSE (B, Hq, Sq) and ``do``, each in its input's
    type; a row with no visible key gets zero gradients."""
    return _bwd(q, k, v, o, lse, do, q_offset=q_offset, window=window,
                block_k=block_k, scale=scale, dq_part=True, dkdv_part=True)


def flash_bwd_dq_ref(q, k, v, o, lse, do, *, q_offset: int = 0,
                     window: int | None = None, block_k: int = 512):
    """dq alone (`flash_attention_bwd_ref`'s first gradient)."""
    return _bwd(q, k, v, o, lse, do, q_offset=q_offset, window=window,
                block_k=block_k, scale=None, dq_part=True,
                dkdv_part=False)[0]


def flash_bwd_dkdv_ref(q, k, v, o, lse, do, *, q_offset: int = 0,
                       window: int | None = None, block_k: int = 512):
    """(dk, dv) alone (`flash_attention_bwd_ref`'s other two)."""
    return _bwd(q, k, v, o, lse, do, q_offset=q_offset, window=window,
                block_k=block_k, scale=None, dq_part=False,
                dkdv_part=True)[1:]

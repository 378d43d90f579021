"""Gradient compression for cross-pod traffic: int8 block quantisation
with error feedback, as the reference's ``repro/optim/compression.py``
computes it, over dicts of tensors.  `torch.round` rounds half to even,
as `jnp.round` does, so the int8 codes are the reference's bit for bit.

`compress -> all-reduce -> decompress` with error feedback is unbiased
in the long run: each step's quantisation error is added into the next
step's gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _quantize(g):
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q, scale, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    size = 1
    for d in shape:
        size *= d
    return flat[:size].reshape(shape)


def compress_grads(grads: dict) -> dict:
    """name -> tensor to name -> {"q": int8 (blocks, 256), "scale":
    float32 (blocks, 1)}."""
    return {k: dict(zip(("q", "scale"), _quantize(g)))
            for k, g in grads.items()}


def decompress_grads(comp: dict, like: dict) -> dict:
    return {k: _dequantize(c["q"], c["scale"], like[k].shape)
            for k, c in comp.items()}


def error_feedback_update(grads: dict, errors: dict | None):
    """Add the carried quantisation error, quantise, and compute the new
    error.  Returns (compressed, decompressed estimate, new errors)."""
    if errors is None:
        errors = {k: torch.zeros_like(g) for k, g in grads.items()}
    corrected = {k: g + errors[k] for k, g in grads.items()}
    comp = compress_grads(corrected)
    est = decompress_grads(comp, corrected)
    new_err = {k: corrected[k] - est[k] for k in corrected}
    return comp, est, new_err

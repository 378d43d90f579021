"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060), used by
mamba2-2.7b (pure SSM stack) and zamba2-1.2b (hybrid backbone).

Projections → causal depthwise conv → SSD scan (chunked for the
no-cache forward and for prefill, the recurrent step for decode) →
gated RMSNorm → out-projection.  The chunked scan is
`repro_torch.kernels.ssd.ssd` (the CUDA kernel for tensors on the card,
its plain torch version on the CPU); the decode step is plain torch.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_step

from .layers import CausalConv1d, Dense, RMSNorm, _param, silu, softplus


class Mamba2Block(nn.Module):
    def __init__(self, d_model: int, *, d_state: int, expand: int = 2,
                 head_dim: int = 64, n_groups: int = 1, conv_width: int = 4,
                 device=None, generator=None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        conv_dim = d_inner + 2 * n_groups * d_state
        kw = dict(device=device, generator=generator)
        # fused input projection in the reference: [x, z, B, C, dt]
        self.in_x = Dense(d_model, d_inner, **kw)
        self.in_z = Dense(d_model, d_inner, **kw)
        self.in_b = Dense(d_model, n_groups * d_state, **kw)
        self.in_c = Dense(d_model, n_groups * d_state, **kw)
        self.in_dt = Dense(d_model, n_heads, **kw)
        self.conv = CausalConv1d(conv_dim, conv_width, **kw)
        self.a_log = _param(torch.full((n_heads,), 0.5, device=device))
        self.dt_bias = _param(torch.zeros(n_heads, device=device))
        self.d_skip = _param(torch.ones(n_heads, device=device))
        self.norm = RMSNorm(d_inner, device=device)
        self.out = Dense(d_inner, d_model, **kw)

    def _split(self, xbc, d_inner: int, d_bc: int):
        return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + d_bc],
                xbc[..., d_inner + d_bc:])

    def forward(self, x, *, d_state: int, head_dim: int = 64,
                n_groups: int = 1, chunk: int = 64,
                cache: dict | None = None):
        """x: (B, S, D).  cache (decode/prefill): {"conv": (B, W-1,
        conv_dim), "ssm": (B, H, P, N)}.  Returns (out, new_cache).

        With a cache and S > 1 (prefill) the chunked scan runs from a
        zero state, not from the cached one (as the reference does), and
        the new cache holds the final SSM state and the conv-window
        tail."""
        bsz, s, _ = x.shape
        n_heads = self.a_log.shape[0]
        d_bc = n_groups * d_state
        z = self.in_z(x)
        xs = self.in_x(x)
        b = self.in_b(x)
        c = self.in_c(x)
        dt = self.in_dt(x)
        d_inner = xs.shape[-1]
        xbc_raw = torch.cat([xs, b, c], dim=-1)
        if cache is not None and s == 1:
            xbc, new_conv = self.conv.step(xbc_raw[:, 0, :], cache["conv"])
            xs, b, c = self._split(silu(xbc[:, None, :]), d_inner, d_bc)
            dt = softplus(dt[:, 0, :] + self.dt_bias.to(dt.dtype))  # (B,H)
            xh = xs[:, 0, :].reshape(bsz, n_heads, head_dim)
            y, new_ssm = ssd_step(cache["ssm"], xh, dt, self.a_log,
                                  b.reshape(bsz, n_groups, d_state),
                                  c.reshape(bsz, n_groups, d_state))
            y = y + self.d_skip.to(y.dtype)[:, None] * xh
            y = y.reshape(bsz, 1, -1)
            new_cache = {"conv": new_conv, "ssm": new_ssm}
        else:
            xs, b, c = self._split(silu(self.conv(xbc_raw)), d_inner,
                                   d_bc)
            dt = softplus(dt + self.dt_bias.to(dt.dtype))          # (B,S,H)
            xh = xs.reshape(bsz, s, n_heads, head_dim)
            y, final_state = ssd_ops.ssd(
                xh.contiguous(), dt.contiguous(), self.a_log,
                b.reshape(bsz, s, n_groups, d_state).contiguous(),
                c.reshape(bsz, s, n_groups, d_state).contiguous(),
                chunk=min(chunk, s) if cache is not None else chunk)
            y = y + self.d_skip.to(y.dtype)[None, None, :, None] * xh
            y = y.reshape(bsz, s, -1)
            new_cache = None
            if cache is not None:
                w = cache["conv"].shape[1]
                new_cache = {"conv": xbc_raw[:, -w:, :].to(cache["conv"].dtype),
                             "ssm": final_state.to(cache["ssm"].dtype)}
        y = self.norm(y * silu(z))
        return self.out(y), new_cache


def mamba2_cache_shapes(batch: int, *, d_model: int, d_state: int,
                        expand: int = 2, n_groups: int = 1,
                        conv_width: int = 4, head_dim: int = 64,
                        dtype=torch.float32) -> dict:
    """(shape, dtype) of one layer's decode cache."""
    d_inner = expand * d_model
    conv_dim = d_inner + 2 * n_groups * d_state
    n_heads = d_inner // head_dim
    return {"conv": ((batch, conv_width - 1, conv_dim), dtype),
            "ssm": ((batch, n_heads, head_dim, d_state), torch.float32)}

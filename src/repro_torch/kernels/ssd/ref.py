"""Plain torch Mamba2 SSD (state-space duality) chunked scan
(arXiv:2405.21060, Algorithm "SSD"): the oracle for the CUDA kernel and
the path tensors on the CPU take; `ssd_chunked_bwd`, its gradients by
autograd (the oracle of the backward kernel); and `ssd_step`, the decode
step.

Selective state space recurrence, per head h with head dim P and state N:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t ⊗ x_t         (P, N)
    y_t = h_t @ C_t + D * x_t

The chunked form splits the sequence into chunks of length L:
 - intra-chunk: a (masked, decay-weighted) attention-like quadratic term,
 - chunk states: decay-weighted sum of B⊗x within each chunk,
 - inter-chunk: a loop over per-chunk states,
 - output: intra + C·(carried state) (the caller adds the skip).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(log_a):
    """(..., L) -> (..., L, L) lower-triangular pairwise decay sums:
    out[i, j] = sum_{k=j+1..i} log_a[k]  (i >= j), -inf above diagonal."""
    length = log_a.shape[-1]
    x = torch.cumsum(log_a, dim=-1)
    diff = x[..., :, None] - x[..., None, :]
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int = 64,
                initial_state=None):
    """Chunked SSD scan.

    x:  (B, S, H, P)   inputs (already gated/conv'd)
    dt: (B, S, H)      positive step sizes (softplus applied by caller)
    a_log: (H,)        A = -exp(a_log)
    b, c: (B, S, G, N) input/output projections (G groups broadcast to H)
    Returns y: (B, S, H, P) in x's dtype, final_state: (B, H, P, N) f32.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    s_orig = s
    if s % chunk:
        # pad with dt = 0 steps: decay exp(0·A) = 1 and zero B·x update,
        # so both outputs and the final state are unaffected.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    a = -torch.exp(a_log.float())                            # (H,)
    dta = dt.float() * a                                     # log-decay
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    dtac = dta.reshape(bsz, nc, chunk, h)
    bc = torch.repeat_interleave(
        b.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()
    cc = torch.repeat_interleave(
        c.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()

    # One inclusive cumsum over the chunk axis (not the innermost one:
    # on the card torch sums it in order, as the kernel does) serves both
    # the intra-chunk decay and the chunk states, as in the TPU kernel.
    cum = torch.cumsum(dtac, dim=2)                          # (B,nc,L,H)

    # ---- intra-chunk (quadratic, attention-like) -------------------------
    cum_h = cum.movedim(-1, -2)                              # (B,nc,H,L)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ss = torch.where(tril, cum_h[..., :, None] - cum_h[..., None, :],
                     -torch.inf)                             # (B,nc,H,L,L)
    decay = torch.exp(ss)
    scores = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)
    dt_j = dtc.movedim(-1, -2)                               # (B,nc,H,L)
    gates = scores * decay * dt_j[..., None, :]              # dt on j axis
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", gates, xc)

    # ---- chunk states -----------------------------------------------------
    total = cum[:, :, -1:, :]                                # (B,nc,1,H)
    state_decay = torch.exp(total - cum)                     # decay j -> end
    sb = bc * (dtc * state_decay)[..., None]                 # weight B by dt
    states = torch.einsum("bzjhn,bzjhp->bzhpn", sb, xc)      # (B,nc,H,P,N)

    # ---- inter-chunk scan --------------------------------------------------
    chunk_decay = torch.exp(total[:, :, 0, :])               # (B,nc,H)
    carry = (torch.zeros((bsz, h, p, n), device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for z in range(nc):
        prev.append(carry)                                   # emit PREVIOUS
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    # ---- inter-chunk output contribution ----------------------------------
    in_decay = torch.exp(cum)                                # decay start->t
    y_inter = torch.einsum("bzihn,bzhpn->bzihp", cc, prev_states) \
        * in_decay[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), carry


def ssd_chunked_bwd(x, dt, a_log, b, c, dy, d_final=None, *,
                    chunk: int = 64):
    """The gradients of `ssd_chunked` by autograd through it: the plain
    version of the backward kernel (``csrc/ssd_bwd.cu``).  ``dy`` is the
    gradient of y (x's shape), ``d_final`` that of the final state (B, H,
    P, N) or None (zero).  Returns (dx, ddt, d_a_log, db, dc), each in
    its input's type."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
        y, fin = ssd_chunked(*ins, chunk=chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if d_final is not None:
            outs.append(fin)
            grads.append(d_final.float())
        return torch.autograd.grad(outs, ins, grads)


def ssd_step(state, x_t, dt_t, a_log, b_t, c_t):
    """Single-token recurrent update (decode path).

    state: (B, H, P, N); x_t: (B, H, P); dt_t: (B, H);
    b_t, c_t: (B, G, N).  Returns (y_t, new_state).
    """
    bsz, h, p = x_t.shape
    g = b_t.shape[1]
    rep = h // g
    a = -torch.exp(a_log.float())
    da = torch.exp(dt_t.float() * a)                         # (B,H)
    bh = torch.repeat_interleave(b_t, rep, dim=1).float()    # (B,H,N)
    ch = torch.repeat_interleave(c_t, rep, dim=1).float()
    upd = (dt_t.float()[..., None, None]
           * x_t.float()[..., None] * bh[..., None, :])
    new_state = state * da[..., None, None] + upd            # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x_t.dtype), new_state

"""The least work of the SSD scan (`kernels.ssd`'s ``ssd`` and
``ssd_bwd``), counted from the shapes alone: whatever route, precision or
algorithm runs the call, the same shapes give the same count.

The operation is the chunked scan at the configuration's chunk L.  Per
chunk of l steps: the scores C B^T over the chunk's causal pairs, once a
group (l (l + 1) / 2 pairs, N deep); per head the gated scores times x
(the same pairs, P deep), the chunk's state (P x N from l steps) and the
carried state's output (l x P from N); 2 FLOP a multiply-add.  The
backward's products are the two gradients of each of these: twice the
forward's.

Bytes: each input read once and each output written once, activations
at ``act_bytes`` each (the configuration's compute type) and the float32
ones (a_log, the final state, its gradient) at 4.
"""

from __future__ import annotations


def pairs(s: int, chunk: int) -> int:
    """The causal (i, j) pairs the chunks hold: l (l + 1) / 2 in a chunk
    of l steps."""
    total = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        total += ln * (ln + 1) // 2
    return total


def forward_flops(b: int, s: int, h: int, p: int, n: int, g: int,
                  chunk: int) -> float:
    npairs = pairs(s, chunk)
    return 2.0 * b * (g * npairs * n + h * (npairs * p + 2 * s * p * n))


def forward_bytes(b, s, h, p, n, g, act_bytes: int) -> float:
    x = b * s * h * p
    return act_bytes * (2 * x + b * s * h + 2 * b * s * g * n) + \
        4 * (h + b * h * p * n)


def backward_flops(b, s, h, p, n, g, chunk) -> float:
    return 2.0 * forward_flops(b, s, h, p, n, g, chunk)


def backward_bytes(b, s, h, p, n, g, act_bytes: int) -> float:
    """Reads x, dt, B, C, dy and a_log; writes dx, ddt, dB, dC and
    d a_log."""
    x = b * s * h * p
    acts = 3 * x + 2 * b * s * h + 4 * b * s * g * n
    return act_bytes * acts + 4 * 2 * h


def shape(config: dict, traffic: dict) -> tuple:
    """(B, S, H, P, N, G, L) of the Mamba2 layers' scans in a cell."""
    d_inner = config["ssm_expand"] * config["d_model"]
    return (traffic["batch"], traffic["seq_len"],
            d_inner // config["ssm_head_dim"], config["ssm_head_dim"],
            config["d_state"], config["ssm_groups"], config["ssm_chunk"])

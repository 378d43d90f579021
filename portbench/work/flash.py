"""The least work of causal attention, optionally in a sliding window (`kernels.flash_attention`'s
forward and ``flash_attention_bwd``), counted from the shapes alone:
whatever route, precision or algorithm runs the call, the same shapes
give the same count.

Forward: Q K^T and P V over the visible (query, key) pairs, 4 D FLOP a
pair and query head.  Backward, from Q, K, V, the output, its row
log-sum-exps and dO: S recomputed, dP = dO V^T, dV = P^T dO, dK = dS^T Q
and dQ = dS K, 10 D FLOP a pair and query head.

Bytes: each input read once and each output written once, activations
at ``act_bytes`` each (the configuration's compute type) and the row
log-sum-exps at 4.
"""

from __future__ import annotations


def visible_pairs(sq: int, sk: int, window: int | None = None) -> int:
    """Pairs of a causal mask with the queries at the end of the keys:
    query i sees the keys j <= sk - sq + i, and with a ``window`` only
    the last ``window`` of them."""
    off, cap = sk - sq, window if window else sk
    return sum(min(off + i + 1, sk, cap) for i in range(sq))


def forward_flops(b, sq, sk, hq, d, window=None) -> float:
    return 4.0 * d * visible_pairs(sq, sk, window) * hq * b


def forward_bytes(b, sq, sk, hq, hkv, d, act_bytes: int) -> float:
    return act_bytes * (2 * b * sq * hq * d + 2 * b * sk * hkv * d) + \
        4 * b * hq * sq


def backward_flops(b, sq, sk, hq, d, window=None) -> float:
    return 10.0 * d * visible_pairs(sq, sk, window) * hq * b


def backward_bytes(b, sq, sk, hq, hkv, d, act_bytes: int) -> float:
    """Reads Q, K, V, O, dO and the LSE; writes dQ, dK, dV."""
    q, kv = b * sq * hq * d, b * sk * hkv * d
    return act_bytes * (3 * q + 2 * kv + q + 2 * kv) + 4 * b * hq * sq


def shape(config: dict, traffic: dict) -> tuple:
    """(B, S, Hq, Hkv, D, window) of a cell's self-attention."""
    return (traffic["batch"], traffic["seq_len"], config["n_heads"],
            config["n_kv_heads"], config["head_dim"],
            config.get("sliding_window"))

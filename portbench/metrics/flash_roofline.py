"""flash_roofline: flash attention's share of its roofline, in %: the
sum of the calls' least times (`work.flash`, at the cell's causal
self-attention, in its window where the configuration has one) over the device time of the kernels named ``fa_*``.
The calls are the program's launch counters over the traced steps
(``flash_attention``, ``flash_attention_bwd``)."""

from portbench.bench import trace
from portbench.work import flash, peaks


def read(record: dict):
    calls = record["launches"]
    fwd = calls.get("flash_attention", 0)
    bwd = calls.get("flash_attention_bwd", 0)
    spent = trace.device_seconds(
        record, lambda n: trace.base_name(n).startswith("fa_"))
    if not (fwd or bwd) or not spent:
        return None
    b, s, hq, hkv, d, win = flash.shape(record["config"], record["traffic"])
    act = record["config"]["act_bytes"]
    least = fwd * peaks.least_seconds(
        flash.forward_flops(b, s, s, hq, d, win),
        flash.forward_bytes(b, s, s, hq, hkv, d, act)) + \
        bwd * peaks.least_seconds(
            flash.backward_flops(b, s, s, hq, d, win),
            flash.backward_bytes(b, s, s, hq, hkv, d, act))
    return 100.0 * least / spent

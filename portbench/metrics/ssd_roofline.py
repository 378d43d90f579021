"""ssd_roofline: the SSD kernels' share of their roofline, in %: the sum
of the calls' least times (`work.ssd`, at the Mamba2 layers' shape) over
the device time of the kernels named ``ssd_*``.  The calls are the
program's launch counters over the traced steps (``ssd``, ``ssd_bwd``)."""

from portbench.bench import trace
from portbench.work import peaks, ssd


def read(record: dict):
    calls = record["launches"]
    fwd, bwd = calls.get("ssd", 0), calls.get("ssd_bwd", 0)
    spent = trace.device_seconds(
        record, lambda n: trace.base_name(n).startswith("ssd_"))
    if not (fwd or bwd) or not spent:
        return None
    b, s, h, p, n, g, chunk = ssd.shape(record["config"], record["traffic"])
    act = record["config"]["act_bytes"]
    least = fwd * peaks.least_seconds(
        ssd.forward_flops(b, s, h, p, n, g, chunk),
        ssd.forward_bytes(b, s, h, p, n, g, act)) + \
        bwd * peaks.least_seconds(
            ssd.backward_flops(b, s, h, p, n, g, chunk),
            ssd.backward_bytes(b, s, h, p, n, g, act))
    return 100.0 * least / spent

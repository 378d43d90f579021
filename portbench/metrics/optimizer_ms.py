"""optimizer_ms: device ms a step in the `_foreach` kernels
(``multi_tensor_apply``), which `optim.adamw` launches."""

from portbench.bench import trace


def read(record: dict):
    s = trace.device_seconds(record, lambda n: "multi_tensor_apply" in n)
    return 1e3 * s / record["steps"] if s else None

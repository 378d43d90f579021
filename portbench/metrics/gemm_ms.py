"""gemm_ms: device ms a step in the library's matrix products (names
holding ``gemm``, ``nvjet``, ``cutlass`` or ``xmma``): the dense
projections and the unembedding (`models.layers`)."""

from portbench.bench import trace

MARKS = ("gemm", "nvjet", "cutlass", "xmma")


def read(record: dict):
    s = trace.device_seconds(
        record, lambda n: any(m in n.lower() for m in MARKS))
    return 1e3 * s / record["steps"] if s else None

"""elementwise_ms: device ms a step in PyTorch's elementwise kernels
(``elementwise_kernel``, ``vectorized_``): the plain chains of the
Mamba2 layers, the norms and the activations (`models.ssm`,
`models.layers`)."""

from portbench.bench import trace


def read(record: dict):
    s = trace.device_seconds(
        record, lambda n: "elementwise_kernel" in n or "vectorized_" in n)
    return 1e3 * s / record["steps"] if s else None

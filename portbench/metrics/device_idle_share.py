"""device_idle_share: the share of an untraced step in which the device
runs nothing, in %: one less the device's busy time a step (the union
of the device intervals over the traced steps, a step's share of it)
over the mean step wall of the traced run's untraced window.  The busy
time comes from the trace, where the profiler does not slow the device's
own work; the wall from the untraced steps, where it does not slow the
host that launches it."""

from portbench.bench import trace


def read(record: dict):
    wall = record.get("step_wall_s")
    busy = trace.busy_seconds(record) / record["steps"]
    if not wall or not busy:
        return None
    return 100.0 * (1.0 - busy / wall)

"""The traced run's record, read from `torch.profiler`: every device
operation (kernels, copies, sets) with its interval, the benchmark's own
spans around its calls into the program, and the host's operations, all
in microseconds on the profiler's one clock.

From it: the device's busy time in the spans' window (the union of the
device intervals), the device operations that took most time, and the
idle gaps named by what the host was doing (the benchmark span open, and
the innermost host operation open, when the gap began).
"""

from __future__ import annotations

import contextlib
import heapq

#: Prefix of the benchmark's span names.
SPAN = "portbench."


def span(name: str, on: bool):
    """A `torch.profiler.record_function` span ``portbench.<name>`` when
    ``on``, else nothing (the untraced runs carry no span)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(SPAN + name)


def collect(prof) -> dict:
    """{"device": [(name, t0, t1)], "spans": [(name, t0, t1, thread)],
    "host": [(name, t0, t1, thread)]}, each sorted by start.  The
    profiler also draws each span on the device's timeline (a user
    annotation); those are not device operations and are left out."""
    from torch.autograd import DeviceType
    device, spans, host = [], [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (e.name.startswith(SPAN) or
                    getattr(e, "is_user_annotation", False)):
                device.append((e.name, t0, t1))
        elif e.name.startswith(SPAN):
            spans.append((e.name[len(SPAN):], t0, t1, e.thread))
        else:
            host.append((e.name, t0, t1, e.thread))
    return {"device": sorted(device, key=lambda r: r[1]),
            "spans": sorted(spans, key=lambda r: r[1]),
            "host": sorted(host, key=lambda r: r[1])}


def window(rec: dict) -> tuple[float, float] | None:
    """(start, end) of the benchmark's spans, or None without one."""
    if not rec["spans"]:
        return None
    return (min(s[1] for s in rec["spans"]), max(s[2] for s in rec["spans"]))


def busy_intervals(rec: dict) -> list[tuple[float, float]]:
    """The union of the device intervals inside the window."""
    win = window(rec)
    if win is None:
        return []
    out: list = []
    for _, t0, t1 in rec["device"]:
        t0, t1 = max(t0, win[0]), min(t1, win[1])
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def busy_seconds(rec: dict) -> float:
    return sum(t1 - t0 for t0, t1 in busy_intervals(rec)) / 1e6


def window_seconds(rec: dict) -> float:
    win = window(rec)
    return 0.0 if win is None else (win[1] - win[0]) / 1e6


def device_seconds(rec: dict, match) -> float:
    """Seconds of the device operations whose name ``match`` accepts."""
    return sum(t1 - t0 for name, t0, t1 in rec["device"] if match(name)) \
        / 1e6


def kernel_name(name: str) -> str:
    """A device operation's name without ``void ``, an anonymous
    namespace and its arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0]


def base_name(name: str) -> str:
    """A kernel's own name: `kernel_name` without its namespaces and
    template arguments (``ssd_states``, ``fa_tc_kernel``)."""
    return kernel_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


def top_device_ops(rec: dict, steps: int, top: int = 10) -> list:
    """[[name, seconds a step]] of the device operations that took most
    time."""
    by: dict = {}
    for name, t0, t1 in rec["device"]:
        key = kernel_name(name)[:120]
        by[key] = by.get(key, 0.0) + (t1 - t0) / 1e6
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / max(steps, 1)] for k, v in ranked]


def idle_gaps(rec: dict, top: int = 10) -> list:
    """[[what the host was doing, idle seconds]]: the window's idle
    time, summed by the benchmark span and the host operation open where
    each gap began (of those open on any thread, the one that began
    last), largest first."""
    win = window(rec)
    if win is None:
        return []
    gaps, at = [], win[0]
    for t0, t1 in busy_intervals(rec):
        if t0 > at:
            gaps.append((at, t0))
        at = t1
    if win[1] > at:
        gaps.append((at, win[1]))
    starts = [g0 for g0, _ in gaps]
    spans = _open_at(rec["spans"], starts)
    ops = _open_at(rec["host"], starts)
    by: dict = {}
    for (g0, g1), label, op in zip(gaps, spans, ops):
        key = " > ".join(x for x in (label or "between spans", op)
                         if x)[:160]
        by[key] = by.get(key, 0.0) + (g1 - g0) / 1e6
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]


def _open_at(rows: list, times: list) -> list:
    """For each of the ascending ``times``, the name of the row (sorted
    by start) open then that began last, or None."""
    out, heap, i = [], [], 0
    for t in times:
        while i < len(rows) and rows[i][1] <= t:
            heapq.heappush(heap, (-rows[i][1], i))
            i += 1
        while heap and rows[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        out.append(rows[heap[0][1]][0] if heap else None)
    return out

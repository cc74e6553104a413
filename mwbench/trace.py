"""A traced segment: torch.profiler over a callable, its chrome trace
written to a temporary file of `TMPDIR`, read back and deleted. What the
readers of per-layer metrics get from it (`Trace`):

- `kernels`: (name, start us, duration us) of every device kernel;
- `busy_s`: seconds of the segment in which a kernel, copy or fill ran on
  the device (the union of their intervals);
- `window_s`: the segment's length, from the `mwbench.window` annotation
  that wraps it (the work and a synchronise at its end);
- `device_ops`: the ten kernels that took most time, by name;
- `idle_gaps`: the ten host operations that most idle time on the device
  waited for: each gap between busy intervals is charged to the operation
  that launched the kernel ending it (the benchmark's label / the ATen op).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    kernels: list
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


def run(fn) -> Trace | None:
    """`fn()` under the profiler (CPU and CUDA activity); None where the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("mwbench.window"):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarise(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(events) -> Trace | None:
    """The `Trace` of a chrome trace's events."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == "mwbench.window"
           and e.get("cat") in ("user_annotation", "cpu_op")]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not win or not device:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    busy = [(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1]
    busy_us = sum(b - a for a, b in busy)
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in device
               if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    for name, _, dur in kernels:
        by_name[name[:160]] += dur * 1e-6
    # who launched each device event: runtime call -> the CPU op around it
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    labels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name") != "mwbench.window")
    ops_start = [o[0] for o in ops]
    lab_start = [o[0] for o in labels]

    def innermost(seq, starts, t):
        best = None
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 64, -1), -1):
            a, b, name = seq[j]
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = seq[j]
        return best[2] if best else None

    starts = sorted(((float(e["ts"]), e.get("args", {}).get("correlation"))
                     for e in device), key=lambda x: x[0])
    gaps = collections.Counter()
    prev_end = w0
    si = 0
    for a, b in busy:
        gap = a - prev_end
        if gap > 0:
            while si < len(starts) and starts[si][0] < a:
                si += 1
            corr = starts[si][1] if si < len(starts) else None
            t = launch_ts.get(corr)
            if t is None:
                who = "no launch found"
            else:
                lab = innermost(labels, lab_start, t) or "-"
                op = innermost(ops, ops_start, t) or "-"
                who = f"{lab} / {op}"
            gaps[who] += gap * 1e-6
        prev_end = max(prev_end, b)
    if w1 > prev_end:
        gaps["end of window / synchronise"] += (w1 - prev_end) * 1e-6
    return Trace(kernels=kernels, busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
                 device_ops=[[k, v] for k, v in by_name.most_common(10)],
                 idle_gaps=[[k, v] for k, v in gaps.most_common(10)])

"""Runs one cell of BENCHMARK.json once and prints its result.

    python3 -m mwbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (build the program's engine, the traffic's state, a short warm-up)
is timed from process start; then the window runs for `--seconds`; then,
with `--trace 1`, a short profiled segment of the same traffic; then the
program's state is released and the plain reference checks what the window
produced. The last line of standard output is the result (JSON): with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics and the trace's breakdown. The numbers compared and their limits
come last in it, under `checks`, and as the last lines of standard error.

Needs as many CUDA devices as the cell asks for, or exits non-zero with no
result; so does a run that finds the JAX package or JAX loaded, or a
reference that imports anything but itself, torch, numpy and the standard
library.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from mwbench import cells, fence  # noqa: E402


class Refused(RuntimeError):
    """A run that may print no result."""


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: object
    device_kind: str
    layout: dict
    window: dict
    spans: dict
    trace: object
    profiled_steps: int
    memory_peak_bytes: int
    setup_s: float


def _deep_update(d: dict, u: dict) -> dict:
    out = dict(d)
    for k, v in u.items():
        out[k] = _deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _log(msg: str):
    print(f"[mwbench] {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root=None, overrides=None, t_start=None) -> dict:
    """One run of the cell `name`; returns the result. `device` other than
    None (a test on the CPU) skips the look for CUDA devices; `overrides`
    ({"config": {...}, "traffic": {...}}) changes the cell's files for it."""
    t_start = T_START if t_start is None else t_start
    cell = cells.load(name, root)
    if overrides:
        cell.config = _deep_update(cell.config, overrides.get("config", {}))
        cell.traffic = _deep_update(cell.traffic, overrides.get("traffic", {}))
    bad_imports = fence.reference_imports()
    if bad_imports:
        raise Refused(f"the reference imports outside itself: {bad_imports}")
    import torch

    from mwbench import trace as trace_mod
    from mwbench import traffic

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise Refused(f"needs {cell.chips} CUDA device(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        dev = torch.device(device)
    cuda = dev.type == "cuda"
    # the stated precision: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    loop = traffic.make(cell, seed, dev, trace)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s")
    window = loop.window(seconds)
    _log(f"window {window}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    layout = loop.layout()
    tr, profiled = None, 0
    if trace and cuda:
        # a segment of about `seconds`, in whole units (a step; an update)
        prof, per_unit = cell.traffic["profile"], layout["steps_per_unit"]
        unit_s = window["window_s"] / max(1, window["steps"] // per_unit)
        units = int(min(prof["max_units"], max(prof["min_units"],
                                               round(prof["seconds"] / unit_s))))
        t0 = time.perf_counter()
        tr = trace_mod.run(lambda: loop.profile(units))
        profiled = units * per_unit
        _log(f"profiled {units} unit(s) and read the trace in "
             f"{time.perf_counter() - t0:.3f} s")
    loop.release()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell.traffic["limits"]
    t0 = time.perf_counter()
    nums, _, rejected = loop.check(limits)
    _log(f"check {time.perf_counter() - t0:.3f} s; leaves left out of change_gap: "
         f"{getattr(loop, 'unmoved_leaves', None)}")
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(cell=cell, device_kind=kind, layout=layout, window=window,
                  spans=loop.spans, trace=tr, profiled_steps=profiled,
                  memory_peak_bytes=peak, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type, "kind": kind,
                "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window["env_steps"],
              "failed": rejected, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    banned = fence.loaded_banned()
    if banned:
        raise Refused(f"modules of JAX or the JAX package are loaded: {banned}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as exc:
        print(f"mwbench: {exc}", file=sys.stderr, flush=True)
        return 2
    layout_line = {k: v for k, v in result.items() if k != "checks"}
    print(f"[mwbench] {args.workload} seed {args.seed}: correct {result['correct']}, "
          f"{json.dumps(layout_line['metrics'])}", flush=True)
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

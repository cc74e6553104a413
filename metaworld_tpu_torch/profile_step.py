"""Where the fused multi-task step spends the host's time, layer by layer.

    python -m metaworld_tpu_torch.profile_step [--tasks mt10|mt25|mt50]
        [--envs 131072] [--steps 20] [--device cuda|cpu]

Builds the engine with `bench.build_envs` (bench.py's layout of the task
set, MT10 by default) and runs it with the tracer on (`tracing`): three
warm-up steps, the first of which loads the kernel library, then `--steps`
steps of fresh uniform actions. Prints the set-up's spans (`engine.*`,
`physics.load`) in ms, then every span of the step (`step`, `step.*`,
`physics.*`) in host ms per step, total and self (less its children's
spans), then how the measured steps ran (`vector`'s counters and the share
that replayed the engine's CUDA graph), each line beside the card's name
and power limit, and a JSON line last. On the card the layers' spans run
only where the engine's constructor steps once and captures its graph
(`engine.graph`); a replayed step has the spans `step` and `step.graph`. The steps issue their work with no synchronise, so the times are what
the host spends issuing each layer, which paces the step while the card
waits; `wall_ms_per_step` is the same steps from a synchronise before the
first to one after the last. Runs on the card; `--device cpu` runs the
plain physics on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from metaworld_tpu_torch import devices, tracing, vector
from metaworld_tpu_torch.bench import TASK_SETS, build_envs


def per_name_ms(records, steps: int = 1) -> dict:
    """{span name: {"total": ms, "self": ms}} summed over `records` and
    divided by `steps`, in the order the names first appear."""
    own = tracing.self_ns(records)
    out = collections.defaultdict(lambda: {"total": 0.0, "self": 0.0})
    for r, s in zip(records, own):
        out[r.name]["total"] += (r.end_ns - r.start_ns) * 1e-6 / steps
        out[r.name]["self"] += s * 1e-6 / steps
    return dict(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", choices=sorted(TASK_SETS), default="mt10")
    ap.add_argument("--envs", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --device cpu)")
    card = devices.card() if dev.type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    tracing.enable()
    eng = build_envs(dev, args.envs, args.tasks)
    state, _ = eng.reset()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def act():
        return torch.rand(eng.num_envs, 4, generator=gen, device=dev) * 2 - 1

    for _ in range(3):
        state, _ = eng.step(state, act())
    sync()
    setup = {k: v["total"] for k, v in per_name_ms(tracing.take()[0]).items()
             if k.startswith("engine.") or k == "physics.load"}
    for k, v in setup.items():
        print(f"[setup] {card}: {args.tasks} {k} {v:.3f} ms")

    acts = [act() for _ in range(args.steps)]
    sync()
    vector.reset_counts()
    tracing.enable()
    t0 = time.perf_counter()
    for a in acts:
        state, _ = eng.step(state, a)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    records, dropped = tracing.take()
    spans = per_name_ms(records, args.steps)
    for k, v in spans.items():
        print(f"[span] {card}: {args.tasks} {k} {v['total']:.4f} ms a step, "
              f"self {v['self']:.4f} ms")
    print(f"[step] {card}: {args.tasks} wall {wall_ms:.4f} ms a step "
          f"over {args.steps} steps ({dropped} spans dropped)")
    graph = {"captures": vector.graph_captures, "replays": vector.graph_replays,
             "eager_steps": vector.eager_steps,
             "state_copy_ins": vector.state_copy_ins, "hit_share": vector.hit_share()}
    print(f"[graph] {card}: {args.tasks} " + ", ".join(f"{k} {v}" for k, v in graph.items()))
    print(json.dumps({"card": card, "tasks": args.tasks, "envs": eng.num_envs,
                      "steps": args.steps, "setup_ms": setup, "span_ms": spans,
                      "wall_ms_per_step": wall_ms, "graph": graph}))


if __name__ == "__main__":
    main()

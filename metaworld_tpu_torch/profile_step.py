"""Where the fused multi-task step spends its time on the GPU.

    python -m metaworld_tpu_torch.profile_step [--tasks mt10|mt25|mt50]
        [--envs 131072] [--reps 20]

Builds the engine as bench.py lays out MT10 (one-hot ids, counts split
evenly over the tasks of the task set, MT10 by default), then times each layer of
`vector.FusedBatchedEnvs.step` with CUDA events on the same inputs: the
weld target, state packing, the physics kernel, unpacking, the non-finite
guard, the per-task observation/reward tails and NEXT_STEP autoreset, and
the whole step. A short torch.profiler window then gives the device busy
share of the step and the number of device kernels it launches. Prints one
line per measurement, each beside the card's name and power limit, and a
JSON line last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.envs.core import post_step
from metaworld_tpu_torch.physics import cuda_step
from metaworld_tpu_torch.types import tree_map


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


TASK_SETS = {"mt10": benchmarks.MT10, "mt25": benchmarks.MT25,
             "mt50": benchmarks.MT50}


def bench_engine(dev, n_envs, tasks="mt10", **kw) -> vector.FusedBatchedEnvs:
    """A task set as bench.py lays out MT10: one-hot ids, `n_envs` slots
    split evenly over its tasks (the remainder to the first); `kw` goes to
    FusedBatchedEnvs."""
    bench = TASK_SETS[tasks](seed=0)
    names = list(bench.train_classes.keys())
    base, rem = divmod(n_envs, len(names))
    counts = [base + (1 if i < rem else 0) for i in range(len(names))]
    return vector.FusedBatchedEnvs(
        [bench.train_classes[n] for n in names], counts,
        [bench.goal_table(n) for n in names], goal_visible=True, one_hot=True,
        device=dev, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", choices=sorted(TASK_SETS), default="mt10")
    ap.add_argument("--envs", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = _card()

    eng = bench_engine(dev, args.envs, args.tasks)
    state, _ = eng.reset()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    act = torch.rand(eng.num_envs, 4, generator=gen, device=dev) * 2 - 1
    for _ in range(3):
        state, _ = eng.step(state, act)
    env, sim = state.env, state.env.sim
    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
    ctl = torch.cat([target.T, effort[None]]).contiguous()
    rows = cuda_step.pack_sim_rows(sim)
    cuda_step.reset_counts()
    eng.step(state, act)
    if cuda_step.launches != 1 or min(cuda_step.launches_by_variant) == 0:
        raise SystemExit(f"expected one kernel launch running every variant per "
                         f"step, got {cuda_step.launches} {cuda_step.launches_by_variant}")
    out_rows = cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks)
    offs = eng._offsets

    def guard():
        n = eng.num_envs
        stable = (torch.isfinite(sim.hand).all(-1)
                  & torch.isfinite(sim.obj_pos).reshape(n, -1).all(-1)
                  & torch.isfinite(sim.joint_q).all(-1)
                  & torch.isfinite(sim.gripper))
        return vector._select(stable, sim, env.sim)

    def tails():
        for i, spec in enumerate(eng.specs):
            a, b = int(offs[i]), int(offs[i + 1])
            post_step(spec, tree_map(lambda x: x[a:b], env), act[a:b])

    def autoreset():
        r = eng._reset_rows(state.goal_idx)
        vector._select(state.pending_reset,
                       tree_map(lambda t: t[r], eng._reset_env), env)
        return eng._reset_obs[r]

    layers = {
        "weld_target": lambda: cuda_step._sim_and_ctl(table, ids, sim, act),
        "pack": lambda: cuda_step.pack_sim_rows(sim),
        "kernel": lambda: cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks),
        "unpack": lambda: cuda_step.unpack_sim_rows(out_rows, mocap),
        "guard": guard,
        "tails": tails,
        "autoreset": autoreset,
        "step": lambda: eng.step(state, act),
    }
    ms = {k: _time_ms(f, args.reps) for k, f in layers.items()}
    for k, v in ms.items():
        print(f"[layer] {card}: {args.tasks} {k} {v:.4f} ms")

    # device busy share and kernel count of the step, from torch.profiler
    prof_info = {}
    try:
        from torch.profiler import ProfilerActivity, profile

        n_steps = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s = state
            for _ in range(n_steps):
                s, _ = eng.step(s, act)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_us, n_kernels = 0.0, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_us += e.time_range.elapsed_us()
                n_kernels += 1
        prof_info = {"wall_ms_per_step": wall_ms / n_steps,
                     "device_ms_per_step": dev_us / 1e3 / n_steps,
                     "device_kernels_per_step": n_kernels / n_steps}
        print(f"[profile] {card}: {prof_info}")
    except Exception as exc:  # the profiler may not reach the device here
        print(f"[profile] unavailable: {exc!r}")
    print(json.dumps({"card": card, "tasks": args.tasks, "envs": eng.num_envs,
                      "layer_ms": ms,
                      "profile": prof_info}))


if __name__ == "__main__":
    main()

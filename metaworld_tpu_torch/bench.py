"""Throughput of the fused multi-task step: the port's counterpart of
bench.py.

    python -m metaworld_tpu_torch.bench [--tasks mt10|mt25|mt50]
        [--envs 131072] [--steps 250] [--rounds 4] [--seed 0]
        [--device cuda|cpu]

Builds the task set as bench.py lays out MT10 (`build_envs`), then runs
bench.py's rollout: every step draws fresh uniform actions in [-1, 1) from
a `torch.Generator` seeded with `--seed` and adds the step's summed reward
into a device scalar, with nothing read by the host inside a round. One
warm-up round, then `--rounds` timed rounds of `--steps` steps; the value
is env-steps per second over the wall time between a synchronise before the
first timed round and one after the last. Each round is also timed with
CUDA events, which gives its ms per step and the spread between rounds.

Checks, each exiting non-zero when it fails: every round, the warm-up too,
runs under `torch.cuda.set_sync_debug_mode("error")` from the first step of
the freshly built engine on; the physics kernel is launched once per step;
every round's summed reward is finite.

Earlier lines give the card's name and power limit, the layout, the round
times, the summed reward and how the steps ran (`vector`'s counters: graph
captures and replays, eager steps, state leaves copied in, and the share
of the steps that replayed the engine's CUDA graph; on the card the engine
captures its graph when it is built); the last line is bench.py's JSON object,
against the 1M env-steps/s target of BASELINE.md. Runs on the card; with
no CUDA device it exits non-zero unless `--device cpu` asks for the plain
physics on the CPU, where there is no host sync or launch to count.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.devices import card, no_host_sync
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.physics import cuda_step

N_ENVS = 131072
STEPS = 250
ROUNDS = 4
BASELINE_STEPS_PER_S = 1_000_000.0  # BASELINE.md: env-steps/s per chip
TASK_SETS = {"mt10": benchmarks.MT10, "mt25": benchmarks.MT25,
             "mt50": benchmarks.MT50}


def task_counts(n_envs: int, n_tasks: int) -> list[int]:
    """`n_envs` slots split evenly over `n_tasks`, the remainder to the
    first tasks."""
    base, rem = divmod(n_envs, n_tasks)
    return [base + (1 if i < rem else 0) for i in range(n_tasks)]


def build_envs(device, n_envs=N_ENVS, tasks="mt10", seed=0,
               reward_function_version="v2", **kw) -> vector.FusedBatchedEnvs:
    """A task set as bench.py lays out MT10: the benchmark's task order and
    goal tables made with `seed`, `task_counts` slots per task, the goal
    visible, one-hot task ids, autoreset and `task_select` at the engine's
    defaults; the tasks' specs of the reward family
    `reward_function_version`. `kw` goes to FusedBatchedEnvs."""
    bench = TASK_SETS[tasks](seed=seed)
    names = list(bench.train_classes.keys())
    return vector.FusedBatchedEnvs(
        [registry.get_spec(n, reward_function_version) for n in names],
        task_counts(n_envs, len(names)), [bench.goal_table(n) for n in names],
        goal_visible=True, one_hot=True, device=device, **kw)


def rollout(envs, state, steps, gen):
    """`steps` fused steps of fresh uniform actions in [-1, 1) from `gen`;
    returns (state, the summed reward as a device scalar)."""
    n, dev = envs.num_envs, envs.device
    total = torch.zeros((), device=dev)
    for _ in range(steps):
        acts = torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
        state, out = envs.step(state, acts)
        total = total + out["reward"].sum()
    return state, total


def _stamp(cuda):
    """A point in time: a CUDA event recorded on the stream (the host does
    not wait) on the card, the host clock on the CPU."""
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def run(envs, tasks="mt10", steps=STEPS, rounds=ROUNDS, seed=0) -> dict:
    """bench.py's rounds on the freshly built engine `envs` of the task set
    `tasks`, with the checks of the module's docstring (a failed one
    raises); prints the round times and the summed reward, and returns
    bench.py's JSON object."""
    dev = envs.device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cuda:
        cuda_step.reset_counts()
    vector.reset_counts()
    with no_host_sync(dev):
        first = _stamp(cuda)
        state, _ = envs.reset(seed=seed)
        state, warm_sum = rollout(envs, state, steps, gen)
        warm_end = _stamp(cuda)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_host_sync(dev):
        marks, sums = [_stamp(cuda)], []
        for _ in range(rounds):
            state, total = rollout(envs, state, steps, gen)
            sums.append(total)
            marks.append(_stamp(cuda))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    warmup_ms = _ms(first, warm_end) / steps
    round_ms = [_ms(a, b) / steps for a, b in zip(marks, marks[1:])]
    sums = [float(warm_sum)] + [float(s) for s in sums]
    reward_sum = sum(sums[1:])
    launches = cuda_step.launches if cuda else None
    print(f"[bench] warm-up round (reset and {steps} steps of the fresh engine): "
          f"{warmup_ms:.4f} ms per step")
    print(f"[bench] {rounds} rounds of {steps} steps x {envs.num_envs} envs, ms per "
          f"step: {', '.join(f'{m:.4f}' for m in round_ms)}; median "
          f"{statistics.median(round_ms):.4f}, min {min(round_ms):.4f}, max "
          f"{max(round_ms):.4f}; wall {wall:.4f} s")
    print(f"[bench] summed reward over the timed rounds {reward_sum!r}; by round "
          f"(warm-up first) {sums}; kernel launches {launches}")
    print(f"[bench] steps: graph captures {vector.graph_captures}, graph replays "
          f"{vector.graph_replays}, eager steps {vector.eager_steps}, state leaves "
          f"copied in {vector.state_copy_ins}, hit share {vector.hit_share()}")
    if not all(np.isfinite(sums)):
        raise RuntimeError(f"bench: a round's summed reward is not finite: {sums}")
    if cuda and launches != steps * (rounds + 1):
        raise RuntimeError(f"bench: {launches} kernel launches for "
                           f"{steps * (rounds + 1)} steps: expected one per step")

    sps = envs.num_envs * steps * rounds / wall
    value = round(sps, 1)
    return {"metric": f"env_steps_per_s_{tasks}_b{envs.num_envs}",
            "value": value, "unit": "steps/s",
            "vs_baseline": round(value / BASELINE_STEPS_PER_S, 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", choices=sorted(TASK_SETS), default="mt10")
    ap.add_argument("--envs", type=int, default=N_ENVS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device; pass --device cpu to run "
                             "the plain physics on the CPU")
        from metaworld_tpu_torch.physics import _build

        print(f"[card] {card()} | {torch.cuda.get_device_name(0)} | torch "
              f"{torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        _build.build_cuda()
        print(f"[build] physics kernel library {time.perf_counter() - t0:.1f} s")
    else:
        print(f"[device] {dev}: the plain physics, no kernel")
    t0 = time.perf_counter()
    envs = build_envs(dev, args.envs, args.tasks)
    print(f"[layout] {args.tasks} N={envs.num_envs}: {len(envs.specs)} tasks x "
          f"{envs.counts[0]}..{envs.counts[-1]} slots, obs width {envs.obs_dim}; "
          f"{len(envs.block_table.host)} blocks by variant v0..v3 "
          f"{envs.block_table.blocks_by_variant}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    result = run(envs, args.tasks, args.steps, args.rounds, args.seed)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

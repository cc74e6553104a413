"""Scripted-policy success sweep: every task x N goals (the reference's
behavioral gold standard: ref tests/.../test_scripted_policies.py asserts
>= 0.80 success per env over its goal set).

Counterpart of `scripts/policy_testing.py`. Each task runs as one fused
MT1 engine with one slot per goal row of `MT1(name, seed)` (rows
0..n_goals-1, pinned), no autoreset, and 500 steps of the task's expert.

    python -m metaworld_tpu_torch.policy_testing
    python -m metaworld_tpu_torch.policy_testing reach-v3 --goals 5 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.evaluation import ScriptedAgent


def run_slots(name: str, n_goals: int = 50, seed: int = 42, steps: int = 500,
              device="cuda") -> torch.Tensor:
    """(n_goals,) success of the expert on goal rows 0..n_goals-1 of
    `MT1(name, seed)`: each slot's max over `steps` steps."""
    envs = vector.from_benchmark(benchmarks.MT1(name, seed=seed),
                                 envs_per_task=n_goals, autoreset=False,
                                 task_select="pseudorandom", device=device)
    agent = ScriptedAgent(envs)
    state, obs = envs.reset(goal_idx=torch.arange(n_goals, dtype=torch.int32))
    succ = torch.zeros(n_goals, device=envs.device)
    for _ in range(steps):
        state, out = envs.step(state, agent.eval_action(obs))
        obs = out["obs"]
        succ = torch.maximum(succ, out["success"])
    return succ


def run_task(name: str, n_goals: int = 50, seed: int = 42, steps: int = 500,
             device="cuda") -> float:
    """The expert's success rate over the first `n_goals` goal rows."""
    return float(run_slots(name, n_goals, seed, steps, device).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=None)
    ap.add_argument("--goals", type=int, default=50,
                    help="goals per task (the reference bar runs 50, "
                         "ref test_scripted_policies.py:26-35)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.names or registry.ALL_V3_ENVIRONMENTS
    results = {}
    for name in names:
        rate = run_task(name, n_goals=args.goals, device=args.device)
        results[name] = rate
        flag = "" if rate >= 0.8 else "  <-- BELOW 0.80"
        print(f"{name}: {rate:.2f}{flag}", flush=True)
    mean = np.mean(list(results.values()))
    n_ok = sum(1 for v in results.values() if v >= 0.8)
    print(f"\nmean success: {mean:.3f}; tasks >= 0.80: {n_ok}/{len(results)}")


if __name__ == "__main__":
    main()

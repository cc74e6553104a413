"""Reward-shape plots along scripted-expert trajectories.

Counterpart of `scripts/plot_rewards.py`: one subplot per task with the v2
reward (and optionally the v1 reward on its own axis) and the first
success. The rollouts run on the device, all tasks in one fused engine
(one slot per task on its first MT1 goal, no autoreset); the drawing runs
on the host with matplotlib, imported by `main` only.

    python -m metaworld_tpu_torch.plot_rewards --envs reach-v3 push-v3 \\
        pick-place-v3 --out /tmp/rewards.png --v1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.evaluation import ScriptedAgent
from metaworld_tpu_torch.types import MAX_RAND
from metaworld_tpu_torch.vector import FusedBatchedEnvs


def traces(names, steps: int = 500, seed: int = 42, device="cuda",
           reward_function_version: str = "v2"):
    """(rewards, successes), each (steps, len(names)) numpy: every task's
    expert from the first goal of `MT1(name, seed)`."""
    tables = []
    for name in names:
        rv = benchmarks.MT1(name, seed=seed).train_tasks[0].rand_vec
        row = np.zeros((1, MAX_RAND))
        row[0, : rv.shape[0]] = rv
        tables.append(row)
    envs = FusedBatchedEnvs(
        [registry.get_spec(n, reward_function_version) for n in names],
        [1] * len(names), tables, autoreset=False, task_select="pseudorandom",
        device=device)
    agent = ScriptedAgent(envs)
    state, obs = envs.reset()
    rew, succ = [], []
    for _ in range(steps):
        state, out = envs.step(state, agent.eval_action(obs))
        obs = out["obs"]
        rew.append(out["reward"])
        succ.append(out["success"])
    return torch.stack(rew).cpu().numpy(), torch.stack(succ).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", nargs="+", default=["reach-v3", "push-v3",
                                                  "pick-place-v3",
                                                  "drawer-open-v3"])
    ap.add_argument("--out", default="rewards.png")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--v1", action="store_true",
                    help="overlay the legacy v1 reward (own scale, right axis)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r2, s2 = traces(args.envs, args.steps, args.seed, args.device)
    if args.v1:
        r1, _ = traces(args.envs, args.steps, args.seed, args.device, "v1")
    n = len(args.envs)
    cols = min(n, 3)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows),
                             squeeze=False)
    for i, name in enumerate(args.envs):
        ax = axes[i // cols][i % cols]
        ax.plot(r2[:, i], label="v2 reward", color="tab:blue")
        if s2[:, i].max() > 0:
            succ_at = int(np.argmax(s2[:, i]))
            ax.axvline(succ_at, color="tab:green", ls="--",
                       label=f"success @ {succ_at}")
        if args.v1:
            ax2 = ax.twinx()
            ax2.plot(r1[:, i], label="v1 reward", color="tab:orange", alpha=0.6)
            ax2.set_ylabel("v1")
        ax.set_title(name)
        ax.set_xlabel("step")
        ax.set_ylabel("v2")
        ax.legend(loc="lower right", fontsize=8)
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

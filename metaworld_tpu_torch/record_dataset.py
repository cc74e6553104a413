"""Record an offline dataset: scripted-expert rollouts -> the native store.

Counterpart of `scripts/record_dataset.py`. The fused engine steps the
batch on the device (one kernel launch per step on a CUDA device); each
step's transition batch (obs, action, reward, done, success) is copied to
the host and pushed into the C++ ring buffer of `native.TrajectoryWriter`,
whose background thread does the disk IO.

    python -m metaworld_tpu_torch.record_dataset --envs reach-v3 drawer-open-v3 \\
        --episodes 2 --out /tmp/mw_dataset.ts
    python -m metaworld_tpu_torch.record_dataset --replay /tmp/mw_dataset.ts

The default `--out` is `mw_dataset.ts` in the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.evaluation import ScriptedAgent
from metaworld_tpu_torch.native import TrajectoryReader, TrajectoryWriter


def make_envs(names, envs_per_task: int, device="cuda"):
    """The fused engine over the tasks `names` (goal tables of
    `benchmarks._mt(names, seed=0)`), `envs_per_task` slots each."""
    return vector.from_benchmark(benchmarks._mt(list(names), seed=0),
                                 envs_per_task=envs_per_task, device=device)


def record(envs, agent, writer, episodes: int, steps: int, seed: int = 0):
    """`episodes` x `steps` steps of `agent` on `envs` from a reset with
    `seed`; every step writes one record of the pre-step observations, the
    actions and the step's reward, done and success to `writer` (the
    writer's host copy is the loop's one wait on the device). Flushes the
    writer at the end."""
    state, obs = envs.reset(seed=seed)
    for _ in range(episodes):
        for _ in range(steps):
            acts = agent.eval_action(obs)
            state, out = envs.step(state, acts)
            writer.write({"obs": obs, "action": acts, "reward": out["reward"],
                          "done": out["done"], "success": out["success"]})
            obs = out["obs"]
    writer.flush()


def replay(path) -> tuple[int, int, list]:
    """(records, batch-steps, sorted keys) of a recorded file."""
    n, steps, keys = 0, 0, None
    for rec in TrajectoryReader(path):
        if keys is None:
            keys = sorted(rec)
        steps += rec["reward"].shape[0]
        n += 1
    return n, steps, keys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", nargs="+", default=["reach-v3"])
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--envs-per-task", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mw_dataset.ts"))
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--replay", default=None,
                    help="read a recorded file back and print its contents")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.replay:
        n, steps, keys = replay(args.replay)
        print(f"{args.replay}: {n} chunks, {steps} batch-steps, keys={keys}")
        return

    envs = make_envs(args.envs, args.envs_per_task, args.device)
    agent = ScriptedAgent(envs)
    t0 = time.time()
    with TrajectoryWriter(args.out) as w:
        record(envs, agent, w, args.episodes, args.steps)
        stats = w.stats()
    dt = time.time() - t0
    steps = args.episodes * args.steps * envs.num_envs
    print(f"wrote {stats} to {args.out}; {steps} env-steps in {dt:.1f}s "
          f"({steps/dt:,.0f} steps/s incl. IO)")


if __name__ == "__main__":
    main()

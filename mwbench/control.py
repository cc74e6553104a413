"""Readings that set the limits of `correct`: the program's numbers over
many seeds (the lower readings), the control's (the upper readings) and,
for a training cell, the faults' readings, each at the cell's own size and
load, all seeds in one process.

    python3 -m mwbench.control --workload <name> --seeds 1,2,3 \\
        [--seconds 3] [--control] [--faults half_batch,altered_answer]

The control is the plain reference put in the program's place, in the
nearest precision below the stated float32 with TF32 off: TF32 products for
a training cell; for the physics, which has no products, bfloat16 (the
reference's step on bfloat16-stored state and actions, its outputs stored
in bfloat16). A fault (`fault`) is planted in the program for its run.
Prints one JSON line per seed and mode, then the lower and upper readings
of each number. Needs a CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from mwbench import cells, traffic


@contextlib.contextmanager
def fault(name: str | None, kind: str = "rollout"):
    """The program with the fault `name` planted, for the block:

    - `unchanged_state`: the fused step returns the state it was given (a
      training cell: the learner leaves the parameters as they were).
    - `half_batch`: the fused step advances only the first half of the
      slots (a training cell: each minibatch's loss is the mean over its
      first half of rows).
    - `altered_answer`: the fused step's reward of slot 0 is off by 1.
    """
    if name is None:
        yield
        return
    from metaworld_tpu_torch import train_ppo, vector

    cls = vector.FusedBatchedEnvs
    step, loss = cls.step, train_ppo.ppo_loss

    def unchanged_step(self, state, actions):
        return state, step(self, state, actions)[1]

    def half_step(self, state, actions):
        new, out = step(self, state, actions)
        h = self.num_envs // 2
        keep = torch.arange(self.num_envs, device=actions.device) < h
        from metaworld_tpu_torch.envs.core import select_slots
        return select_slots(keep, new, state), out

    def altered_step(self, state, actions):
        new, out = step(self, state, actions)
        out = dict(out)
        out["reward"] = out["reward"].clone()
        out["reward"][0] += 1.0
        return new, out

    def half_loss(model, batch, clip):
        return loss(model, [x[: x.shape[0] // 2] for x in batch], clip)

    def no_learn(model, opt, sched, traj, *args):
        return torch.zeros((), device=traj["obs"].device)

    train = kind == "ppo"
    patches = {"unchanged_state": [(train_ppo, "learn", no_learn) if train
                                   else (cls, "step", unchanged_step)],
               "half_batch": [(train_ppo, "ppo_loss", half_loss) if train
                              else (cls, "step", half_step)],
               "altered_answer": [(cls, "step", altered_step)]}[name]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, fn in patches:
            setattr(obj, attr, fn)
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def readings(cell, seed: int, seconds: float, dev, modes) -> list:
    """One run of the cell and its numbers in each of `modes`: "program"
    and "control" share the run; "fault:<name>" plants the fault in it."""
    limits = cell.traffic["limits"]
    planted = [m.split(":", 1)[1] for m in modes if m.startswith("fault:")]
    t0 = time.perf_counter()
    with fault(planted[0] if planted else None, cell.traffic["kind"]):
        loop = traffic.make(cell, seed, dev, False)
        loop.setup()
        window = loop.window(seconds)
        loop.release()
    rows = []
    for mode in modes:
        kw = {}
        if mode == "control":
            kw = ({"tf32": True} if cell.traffic["kind"] == "ppo"
                  else {"ref_dtype": torch.bfloat16})
        nums, compared, rejected = loop.check(limits, **kw)
        rows.append({"seed": seed, "mode": mode, "numbers": nums,
                     "compared": compared, "rejected": rejected,
                     "steps": window["steps"],
                     "correct": all(nums[k] <= v for k, v in limits.items()),
                     "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-envs", type=int, default=0,
                    help="a smaller batch than the cell's (a rehearsal on the CPU)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("mwbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.load(args.workload)
    if args.n_envs:
        cell.config = {**cell.config, "n_envs": args.n_envs}
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = (["program"] if args.program else []) + (["control"] if args.control else [])
    rows = []
    runs = [(seed, modes) for seed in seeds if modes]
    runs += [(seed, [f"fault:{name}"]) for name in filter(None, args.faults.split(","))
             for seed in seeds[: args.fault_seeds]]
    for seed, ms in runs:
        for row in readings(cell, seed, args.seconds, dev, ms):
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for mode in sorted({r["mode"] for r in rows}):
        nums = [r["numbers"] for r in rows if r["mode"] == mode]
        pick = max if mode == "program" else min
        summary[mode] = {k: pick(n[k] for n in nums) for k in nums[0]}
    print(json.dumps({"workload": args.workload, "lower_and_upper": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Counts the float32 operations of one env's physics substep in the plain
reference, for each task of MT50 and each kernel variant sound for it, and
writes them to `physics_ops.json` beside this file (`--check` compares
instead of writing).

    python3 -m mwbench.yardstick.count_physics_ops [--check]

Each elementwise operation on a one-env batch counts once (a multiply-add
counts two, as the published float32 peak does); views, copies and
allocations count nothing. The plain engine masks its branches instead of
taking them, so a variant's count does not depend on the state. The table
is frozen data: a change to the program does not move it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

OUT = pathlib.Path(__file__).resolve().parent / "physics_ops.json"
SKIP = {"select", "slice", "stack", "cat", "clone", "_to_copy", "copy_", "view",
        "unsqueeze", "expand", "zeros_like", "ones_like", "full_like",
        "empty_like", "lift_fresh", "detach", "alias", "t", "transpose",
        "scalar_tensor", "full", "zeros", "ones", "empty", "_local_scalar_dense",
        "squeeze", "unbind", "split", "index"}


class _Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.__name__.split(".")[0] not in SKIP and isinstance(out, torch.Tensor)
                and out.numel() == 1):
            _Count.n += 1
        return out


def lightest_variant(features) -> int:
    """The lightest kernel variant sound for a task's (objects, joints,
    hand boxes) features."""
    o, j, k = (bool(x) for x in features)
    return (3 if o else 2) if j else (1 if k else 0)


def count() -> dict:
    from mwbench.reference import benchmarks
    from mwbench.reference.envs import registry
    from mwbench.reference.envs.core import env_reset
    from mwbench.reference.physics import engine_lanes, plain_step
    from mwbench.reference.types import FRAME_SKIP

    tasks = {}
    for name in registry.ALL_V3_ENVIRONMENTS:
        spec = registry.get_spec(name)
        table = plain_step.build_scene_table([spec.scene], "cpu")
        goal = torch.from_numpy(benchmarks.MT1(name, seed=0).goal_table(name)[:1]).float()
        state, _ = env_reset(spec, goal, 1.0, torch.Generator().manual_seed(0))
        sim = state.sim
        sc = engine_lanes._NS(**plain_step._build_lanes(table.rows.T, plain_step.SC_SPEC))
        feats = table.features[0]
        ops = {}
        for v, flags in enumerate(plain_step.VARIANTS):
            if ((not flags["with_objects"] and feats[0])
                    or (not flags["with_joints"] and feats[1])
                    or (not flags["with_hand_boxes"] and feats[2])):
                continue
            st = engine_lanes.sim_lanes(sim)
            tgt = engine_lanes._v3(sim.hand)
            _Count.n = 0
            with _Count():
                engine_lanes._substep(sc, st, tgt, torch.zeros(1), **flags)
            ops[str(v)] = _Count.n
        tasks[name] = {"variant": lightest_variant(feats), "ops": ops}
    return {"made_by": "python3 -m mwbench.yardstick.count_physics_ops",
            "substeps": FRAME_SKIP, "sim_rows": plain_step.SIM_ROWS,
            "scene_rows": plain_step.SC_ROWS, "tasks": tasks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    table = count()
    if args.check:
        same = json.loads(OUT.read_text()) == table
        print("physics_ops.json reproduced" if same else "physics_ops.json differs")
        return 0 if same else 1
    OUT.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

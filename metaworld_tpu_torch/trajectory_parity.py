"""Open-loop trajectory parity against the reference's recorded traces.

Counterpart of `scripts/trajectory_parity.py` (`rollout`, `score`) and of
the ceilings of `tests/test_trajectory_parity.py`. Each golden trace
(`tests/golden/<task>.npz`, the reference's scripted-policy rollouts with
their per-step obs, reward and success) has its RECORDED ACTION SEQUENCE
replayed through the port from the same task vector, and the per-step
deviation of the observation and reward traces is scored: hand position
(obs[0:3]), main object position (obs[4:7]), reward MAE relative to the
largest reference reward, and whether the replay reaches success where
the reference did.

All tapes replay in one `FusedBatchedEnvs`: one spec with one slot per
task, each goal table the single row of its trace's `attr_last_rand_vec`
(zero-padded to MAX_RAND), `autoreset=False`, `task_select=
"pseudorandom"`: 500 steps of one kernel launch each on a CUDA device.
Open-loop replay compounds: once a contact lands on a different 2.5 ms
substep the trajectories fork, and the ceilings quantify that gap.

    python -m metaworld_tpu_torch.trajectory_parity            # all 50
    python -m metaworld_tpu_torch.trajectory_parity reach-v3 --device cpu
    python -m metaworld_tpu_torch.trajectory_parity --out parity.md

Prints one row per task, and the table to `--out` when it is given.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.types import MAX_RAND
from metaworld_tpu_torch.vector import FusedBatchedEnvs

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"

# (hand_p95_m, obj_p95_m, rew_mae_rel, open_loop_success_agrees): the
# per-task ceilings of tests/test_trajectory_parity.py
CEILINGS = {
    "assembly-v3": (0.035, 0.030, 0.083, 1),
    "basketball-v3": (0.229, 0.248, 0.184, 1),
    "bin-picking-v3": (0.030, 0.030, 0.083, 1),
    "box-close-v3": (0.080, 0.071, 0.093, 1),
    "button-press-topdown-v3": (0.034, 0.030, 0.083, 1),
    "button-press-topdown-wall-v3": (0.031, 0.030, 0.083, 1),
    "button-press-v3": (0.030, 0.030, 0.141, 1),
    "button-press-wall-v3": (0.030, 0.030, 0.100, 1),
    "coffee-button-v3": (0.037, 0.030, 0.083, 1),
    "coffee-pull-v3": (0.045, 0.042, 0.083, 1),
    "coffee-push-v3": (0.030, 0.050, 0.083, 1),
    "dial-turn-v3": (0.062, 0.036, 0.274, 1),
    "disassemble-v3": (0.030, 0.055, 0.083, 1),
    "door-close-v3": (0.032, 0.161, 0.083, 1),
    "door-lock-v3": (0.488, 0.047, 0.109, 1),
    "door-open-v3": (0.105, 0.044, 0.083, 1),
    "door-unlock-v3": (0.188, 0.262, 0.354, 1),
    "drawer-close-v3": (0.049, 0.030, 0.083, 1),
    "drawer-open-v3": (0.073, 0.068, 0.083, 1),
    "faucet-close-v3": (0.242, 0.529, 0.176, 1),
    "faucet-open-v3": (0.236, 0.290, 0.206, 1),
    "hammer-v3": (0.091, 0.113, 0.587, 1),
    "hand-insert-v3": (0.093, 0.083, 0.083, 1),
    "handle-press-side-v3": (0.032, 0.030, 0.083, 1),
    "handle-press-v3": (0.030, 0.044, 0.155, 1),
    "handle-pull-side-v3": (0.030, 0.037, 0.158, 1),
    "handle-pull-v3": (0.042, 0.033, 0.083, 1),
    "lever-pull-v3": (0.218, 0.199, 0.083, 1),
    "peg-insert-side-v3": (0.032, 0.051, 0.083, 1),
    "peg-unplug-side-v3": (0.034, 0.030, 0.083, 1),
    "pick-out-of-hole-v3": (0.030, 0.030, 0.083, 1),
    "pick-place-v3": (0.042, 0.038, 0.083, 1),
    "pick-place-wall-v3": (0.030, 0.030, 0.083, 1),
    "plate-slide-back-side-v3": (0.034, 0.086, 0.182, 1),
    "plate-slide-back-v3": (0.030, 0.094, 0.099, 1),
    "plate-slide-side-v3": (0.042, 0.036, 0.083, 1),
    "plate-slide-v3": (0.056, 0.030, 0.083, 1),
    "push-back-v3": (0.044, 0.066, 0.178, 1),
    "push-v3": (0.042, 0.038, 0.083, 1),
    "push-wall-v3": (0.040, 0.036, 0.083, 1),
    "reach-v3": (0.036, 0.030, 0.083, 1),
    "reach-wall-v3": (0.033, 0.030, 0.083, 1),
    "shelf-place-v3": (0.084, 0.074, 0.083, 1),
    "soccer-v3": (0.042, 0.037, 0.083, 1),
    "stick-pull-v3": (0.104, 0.068, 0.083, 1),
    "stick-push-v3": (0.039, 0.047, 0.083, 1),
    "sweep-into-v3": (0.039, 0.100, 0.138, 1),
    "sweep-v3": (0.030, 0.049, 0.083, 1),
    "window-close-v3": (0.347, 0.030, 0.099, 1),
    "window-open-v3": (0.058, 0.030, 0.139, 1),
}


def load_traces(names) -> list:
    return [dict(np.load(GOLDEN / f"{n}.npz")) for n in names]


def goal_tables(traces) -> list:
    """Each trace's one-row goal table: its task vector, zero-padded."""
    tables = []
    for d in traces:
        rv = np.asarray(d["attr_last_rand_vec"])
        row = np.zeros((1, MAX_RAND))
        row[0, : rv.shape[0]] = rv
        tables.append(row)
    return tables


def replay_engine(names, traces, device="cuda") -> FusedBatchedEnvs:
    """One slot per task, pinned to its trace's task vector."""
    return FusedBatchedEnvs([registry.get_spec(n) for n in names],
                            [1] * len(names), goal_tables(traces),
                            autoreset=False, task_select="pseudorandom",
                            device=device)


def replay(envs, actions):
    """Steps `envs` from a reset through `actions` (T, n, 4) on its
    device. Returns (obs (T, n, 39), reward (T, n), success (T, n),
    obs0 (n, 39)) tensors on the device."""
    state, obs0 = envs.reset()
    obs, rew, succ = [], [], []
    for a in actions:
        state, out = envs.step(state, a)
        obs.append(out["obs"])
        rew.append(out["reward"])
        succ.append(out["success"])
    return torch.stack(obs), torch.stack(rew), torch.stack(succ), obs0


def pairs(traces, obs, rew, succ, obs0) -> list:
    """[(ours, ref)] per task from `replay`'s host arrays, dicts of numpy
    arrays as the JAX script's `rollout` returns them."""
    out = []
    for i, d in enumerate(traces):
        ours = dict(obs=obs[:, i], reward=rew[:, i], success=succ[:, i],
                    obs0=obs0[i])
        # reference: obs[t] is the PRE-step obs; the post-step obs of
        # action t is obs[t+1] (final_obs after the last); reward[t] pairs
        # with action[t]
        ref = dict(obs=np.concatenate([d["obs"][1:], d["final_obs"][None]], 0),
                   reward=d["reward"], success=d["success"], obs0=d["obs"][0])
        out.append((ours, ref))
    return out


def rollout(names, device="cuda"):
    """Open-loop replay of every task's tape in one engine: `pairs`."""
    traces = load_traces(names)
    envs = replay_engine(names, traces, device)
    actions = torch.from_numpy(np.stack([d["action"] for d in traces], 1)
                               .astype(np.float32)).to(envs.device)
    return pairs(traces, *(x.cpu().numpy() for x in replay(envs, actions)))


def score(name: str, ours: dict, ref: dict) -> dict:
    """The JAX script's per-task deviation scores of one replay."""
    o, r = ours["obs"], ref["obs"]
    hand = np.linalg.norm(o[:, 0:3] - r[:, 0:3], axis=1)
    obj = np.linalg.norm(o[:, 4:7] - r[:, 4:7], axis=1)
    rew_err = np.abs(ours["reward"] - ref["reward"])
    rew_scale = max(1.0, np.abs(ref["reward"]).max())
    return {
        "task": name,
        "hand_p50": float(np.percentile(hand, 50)),
        "hand_p95": float(np.percentile(hand, 95)),
        "obj_p50": float(np.percentile(obj, 50)),
        "obj_p95": float(np.percentile(obj, 95)),
        "rew_mae_rel": float(rew_err.mean() / rew_scale),
        "succ_ours": float((ours["success"] > 0).any()),
        "succ_ref": float((ref["success"] > 0).any()),
    }


def over_ceiling(s: dict) -> list[str]:
    """The ceilings of `CEILINGS` that a task's scores break."""
    hand_max, obj_max, mae_max, succ_agrees = CEILINGS[s["task"]]
    out = []
    if not s["hand_p95"] <= hand_max:
        out.append(f"hand p95 {s['hand_p95']*1000:.1f}mm > {hand_max*1000:.0f}mm")
    if not s["obj_p95"] <= obj_max:
        out.append(f"obj p95 {s['obj_p95']*1000:.1f}mm > {obj_max*1000:.0f}mm")
    if not s["rew_mae_rel"] <= mae_max:
        out.append(f"reward MAE {s['rew_mae_rel']:.3f} > {mae_max:.3f}")
    if succ_agrees and not s["succ_ours"] >= s["succ_ref"]:
        out.append("open-loop replay lost success agreement")
    return out


def first_fork(ours: dict, ref: dict) -> int | None:
    """First step whose hand or object position is more than 1 mm off the
    reference, or None."""
    o, r = ours["obs"], ref["obs"]
    d = np.maximum(np.linalg.norm(o[:, 0:3] - r[:, 0:3], axis=1),
                   np.linalg.norm(o[:, 4:7] - r[:, 4:7], axis=1))
    hit = np.flatnonzero(d > 1e-3)
    return int(hit[0]) if hit.size else None


def table(rows) -> str:
    """The markdown table of the JAX script's docs/parity.md."""
    lines = [
        "# Open-loop trajectory parity vs the reference engine",
        "",
        "Generated by `python -m metaworld_tpu_torch.trajectory_parity`. Each",
        "golden trace's recorded action sequence is replayed through the port",
        "from the same task vector; `hand` = end-effector position error (mm),",
        "`obj` = main-object observation error (mm), `rew MAE` = mean absolute",
        "reward error / max |reference reward|, `succ` = does the open-loop",
        "replay reach success where the reference did.",
        "",
        "| task | hand p50 | hand p95 | obj p50 | obj p95 | rew MAE | succ ours/ref |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in rows:
        lines.append(
            f"| {s['task']} | {s['hand_p50']*1000:.1f} | {s['hand_p95']*1000:.1f} "
            f"| {s['obj_p50']*1000:.1f} | {s['obj_p95']*1000:.1f} "
            f"| {s['rew_mae_rel']:.3f} | {s['succ_ours']:.0f}/{s['succ_ref']:.0f} |")
    med_hand = np.median([s["hand_p95"] for s in rows]) * 1000
    med_obj = np.median([s["obj_p95"] for s in rows]) * 1000
    succ = sum(s["succ_ours"] >= s["succ_ref"] for s in rows)
    lines += ["", f"Median across tasks: hand p95 {med_hand:.1f} mm, obj p95 "
              f"{med_obj:.1f} mm; open-loop success agreement {succ}/{len(rows)}.",
              ""]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the markdown table here")
    args = ap.parse_args(argv)
    names = args.names or registry.ALL_V3_ENVIRONMENTS
    rows = []
    for name, (ours, ref) in zip(names, rollout(names, args.device)):
        s = score(name, ours, ref)
        rows.append(s)
        over = over_ceiling(s)
        print(f"{s['task']:32s} hand p95 {s['hand_p95']*1000:7.1f}mm  "
              f"obj p95 {s['obj_p95']*1000:7.1f}mm  "
              f"rew mae {s['rew_mae_rel']:6.3f}  "
              f"succ ours/ref {s['succ_ours']:.0f}/{s['succ_ref']:.0f}"
              + (f"  OVER CEILING: {'; '.join(over)}" if over else ""), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table(rows))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

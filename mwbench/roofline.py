"""The yardstick's arithmetic: the published peaks of a device and the
least time the physics kernel could take for a layout, from the frozen
operation counts of `yardstick/physics_ops.json` (made by
`yardstick/count_physics_ops.py` from the plain reference)."""

from __future__ import annotations

from mwbench.cells import yardstick


def peaks(kind: str) -> dict | None:
    """{"f32_flops": ..., "hbm_bytes_per_s": ...} of the device `kind` (as
    torch.cuda.get_device_name gives it), or None for a device not listed."""
    return yardstick("peaks.json")["devices"].get(kind)


def physics_ops_per_env_step(tasks) -> dict:
    """{task: float32 operations one env of the task needs per control
    step}: its lightest sound variant's count per substep x substeps."""
    table = yardstick("physics_ops.json")
    sub = table["substeps"]
    out = {}
    for t in tasks:
        e = table["tasks"][t]
        out[t] = e["ops"][str(e["variant"])] * sub
    return out


def physics_step(layout: dict) -> tuple:
    """(operations, bytes) of one control step of the physics over the
    layout: each input read and each output written once (state rows in
    and out, four control rows and a task id per env, the scene table)."""
    table = yardstick("physics_ops.json")
    per = physics_ops_per_env_step(layout["tasks"])
    ops = sum(per[t] * c for t, c in zip(layout["tasks"], layout["counts"]))
    n = layout["n_envs"]
    nbytes = n * ((2 * table["sim_rows"] + 4) * 4 + 4) + len(layout["tasks"]) * table["scene_rows"] * 4
    return ops, nbytes


"""The frozen yardstick: the counting script reproduces the operation
table from the plain reference, and the shares it gives stay below 100%."""

from __future__ import annotations

from mwbench import roofline
from mwbench.cells import yardstick
from mwbench.yardstick import count_physics_ops


def test_script_reproduces_the_table():
    assert count_physics_ops.count() == yardstick("physics_ops.json")


def test_published_peak_and_a_bound():
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert peak == {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    tasks = ["reach-v3", "door-open-v3"]
    ops, nbytes = roofline.physics_step({"tasks": tasks, "counts": [3, 5], "n_envs": 8})
    table = yardstick("physics_ops.json")["tasks"]
    assert ops == 5 * (3 * table["reach-v3"]["ops"]["0"] + 5 * table["door-open-v3"]["ops"]["2"])
    assert nbytes == 8 * ((2 * 63 + 4) * 4 + 4) + 2 * 198 * 4

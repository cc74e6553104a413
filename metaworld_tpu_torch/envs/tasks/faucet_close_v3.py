"""faucet-close-v3: rotate the faucet handle clockwise (batched counterpart
of the JAX package's `envs/tasks/faucet_close_v3.py`)."""

from __future__ import annotations

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec
from metaworld_tpu_torch.envs.tasks.faucet_open_v3 import make_faucet_spec


@registry.register("faucet-close-v3")
def make_spec(task_id: int) -> TaskSpec:
    return make_faucet_spec(
        "faucet-close-v3", task_id,
        (-0.1, 0.8, 0.0), (0.1, 0.85, 0.0),
        ccw=False, obj_offset=(0.0, 0.0, 0.0), arm_x=0.015,
    )

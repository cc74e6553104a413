# Frozen copy of metaworld_tpu_torch/envs/tasks/plate_slide_back_side_v3.py at commit 3742bce; imports renamed.
"""plate-slide-back-side-v3: slide the puck from (-0.15, 0.6) right to a
goal in [-0.05, 0.15] x 0.6 (batched counterpart of the JAX package's
`envs/tasks/plate_slide_back_side_v3.py`)."""

from __future__ import annotations

import numpy as np

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec
from mwbench.reference.envs.tasks.plate_slide_v3 import (
    make_puck_reset,
    make_puck_scene,
    staged_puck_reward,
)


@registry.register("plate-slide-back-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="plate-slide-back-side-v3",
        task_id=task_id,
        scene=make_puck_scene(sideways=True),
        rand_low=np.array([-0.25, 0.6, 0.0, -0.05, 0.6, 0.015]),
        rand_high=np.array([-0.25, 0.6, 0.0, 0.15, 0.6, 0.015]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.05, 0.6, 0.015]),
        goal_high=np.array([0.15, 0.6, 0.015]),
        reset_fn=make_puck_reset((-0.15, 0.6, 0.015), cabinet=(-0.3, 0.6, 0.0)),
        reward_fn=staged_puck_reward,
        n_obs_obj=1,
    )

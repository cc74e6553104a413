# Frozen copy of metaworld_tpu_torch/envs/tasks/plate_slide_back_v3.py at commit 3742bce; imports renamed.
"""plate-slide-back-v3: slide the puck from inside the cabinet at
(0, 0.75) back to a goal on y = 0.6 (batched counterpart of the JAX
package's `envs/tasks/plate_slide_back_v3.py`)."""

from __future__ import annotations

import numpy as np

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec
from mwbench.reference.envs.tasks.plate_slide_v3 import (
    make_puck_reset,
    make_puck_scene,
    staged_puck_reward,
)


@registry.register("plate-slide-back-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="plate-slide-back-v3",
        task_id=task_id,
        scene=make_puck_scene(),
        rand_low=np.array([0.0, 0.85, 0.0, -0.1, 0.6, 0.015]),
        rand_high=np.array([0.0, 0.85, 0.0, 0.1, 0.6, 0.015]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.6, 0.015]),
        goal_high=np.array([0.1, 0.6, 0.015]),
        reset_fn=make_puck_reset((0.0, 0.75, 0.015), cabinet=(0.0, 0.85, 0.0)),
        reward_fn=staged_puck_reward,
        n_obs_obj=1,
    )

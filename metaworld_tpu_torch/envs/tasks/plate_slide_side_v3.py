"""plate-slide-side-v3: slide the puck from (0, 0.6) left to a goal in
[-0.3, -0.25] x [0.54, 0.66] (batched counterpart of the JAX package's
`envs/tasks/plate_slide_side_v3.py`)."""

from __future__ import annotations

import numpy as np

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec
from metaworld_tpu_torch.envs.tasks.plate_slide_v3 import (
    make_puck_reset,
    make_puck_scene,
    staged_puck_reward,
)


@registry.register("plate-slide-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="plate-slide-side-v3",
        task_id=task_id,
        scene=make_puck_scene(sideways=True),
        rand_low=np.array([0.0, 0.6, 0.0, -0.3, 0.54, 0.0]),
        rand_high=np.array([0.0, 0.6, 0.0, -0.25, 0.66, 0.0]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.3, 0.54, 0.0]),
        goal_high=np.array([-0.25, 0.66, 0.0]),
        reset_fn=make_puck_reset((0.0, 0.6, 0.015), cabinet=(-0.3, 0.6, 0.0)),
        reward_fn=staged_puck_reward,
        n_obs_obj=1,
    )

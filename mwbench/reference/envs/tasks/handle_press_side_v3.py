# Frozen copy of metaworld_tpu_torch/envs/tasks/handle_press_side_v3.py at commit 3742bce; imports renamed.
"""handle-press-side-v3: press the sideways box handle down (batched
counterpart of the JAX package's `envs/tasks/handle_press_side_v3.py`)."""

from __future__ import annotations

import numpy as np

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec
from mwbench.reference.envs.tasks.handle_press_v3 import (
    handle_obs,
    make_handle_scene,
    press_reset,
    press_reward,
)


@registry.register("handle-press-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="handle-press-side-v3",
        task_id=task_id,
        scene=make_handle_scene((0.216, 0.0, 0.171), press=True, hi=0.17,
                               side=True),
        rand_low=np.array([-0.35, 0.65, -0.001]),
        rand_high=np.array([-0.25, 0.75, 0.001]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=press_reset((0.216, 0.0, 0.171), (0.216, 0.0, 0.075)),
        reward_fn=press_reward,
        obs_fn=handle_obs,
        n_obs_obj=1,
    )

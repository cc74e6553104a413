"""coffee-push-v3: push the mug under the coffee machine (batched
counterpart of the JAX package's `envs/tasks/coffee_push_v3.py`; the
mirror of coffee-pull, with its scene and reward)."""

from __future__ import annotations

import numpy as np

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.coffee_pull_v3 import (
    coffee_mug_scene, good, make_coffee_reward)


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    mug = common.vec3(rand[:, 0], rand[:, 1], 0.0)
    target = rand[:, 3:6]
    return dict(
        obj_pos=common.pad_obj_pos(add_const(mug, (0.0, 0.0, 0.035))),
        obj_init_pos=common.pad_obj_pos(mug),
        target=target,
        fixture_pos=add_const(target, (0.0, 0.22, 0.0)),
    )


@registry.register("coffee-push-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="coffee-push-v3",
        task_id=task_id,
        scene=coffee_mug_scene(),
        rand_low=np.array([-0.1, 0.55, -0.001, -0.05, 0.7, -0.001]),
        rand_high=np.array([0.1, 0.65, 0.001, 0.05, 0.75, 0.001]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.array([-0.05, 0.7, -0.001]),
        goal_high=np.array([0.05, 0.75, 0.001]),
        obj_report_off=np.array([[0.0, 0.0, -0.035], [0.0, 0.0, 0.0]],
                                np.float32),
        reset_fn=_reset,
        reward_fn=make_coffee_reward(),
        n_obs_obj=1,
    )

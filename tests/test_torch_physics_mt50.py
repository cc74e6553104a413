"""The port's lane physics (the CUDA kernel's plain version) against the
JAX package's `engine_lanes.control_step` on one batch that holds the 22
scenes MT50 adds to MT25 and its helper tasks: an anchored plug with a
hook grasp (peg-unplug-side), a hinge panel without a hook (door-close),
slide-limited pucks that are not planar (plate-slide x4), a 10 cm pit
(hand-insert), hookable slide handles that are pulled (handle-pull x2)
and the one scene with both an object and a joint (hammer).

Random and seek modes, 25 steps each, with the tolerances and the eager
rerun rule of test_torch_physics.py; the seek mode, whose eager reruns
make it the longer, is in test_torch_physics_mt50_seek.py and
test_torch_physics_mt50_seek_b.py, half the tasks each. In the seek
mode every slot starts 3 cm above its target, steers to it and closes the
grip there; of each task's three slots one seeks the object's reset
anchor (obj_init_pos), one the position its reset observation reports (a
handle, a lever, the plug's end) and one the object's grasp point (its
center plus the scene's grasp offset: the hammer's handle, the lid's
knob). The seek mode must unanchor the plug, attach the hammer and hook
both pulled handles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch.envs.core import env_reset
from tests.test_torch_env_mt50 import NEW
from tests.test_torch_physics import (
    TCP_OFFSET, check_control_step, reset_batch)

PER_TASK = 3


def seek_targets(anchor, reported, center, grasp_off, has_obj, per_task):
    """(n, 3) seek targets of a batch of `per_task` slots per task, task
    after task: the three kinds of the docstring in turn over each task's
    slots (slot % 3 within the task), the reset anchor, the reported
    position and the grasp point (`center` + `grasp_off`; the reported
    position where `has_obj` is false). The one rule of the seek mode for
    the physics and the kernel-host tests; chip_smoke.py keeps a copy."""
    grasp = np.where(np.asarray(has_obj)[:, None],
                     np.asarray(center) + np.asarray(grasp_off), reported)
    kind = (np.arange(len(anchor)) % per_task % 3)[:, None]
    return np.select([kind == 0, kind == 1], [anchor, reported],
                     grasp).astype(np.float32)


def batch_seek_targets(env, scene, names, per_task):
    """`seek_targets` of a JAX reset batch. Reset observations come from the
    port's reset of the same goal rows (held against the JAX reset at
    1e-6)."""
    obs = []
    for name in names:
        bench = tbench.MT1(name, seed=0, num_goals=per_task)
        rows = torch.from_numpy(bench.goal_table(name).astype(np.float32))
        obs.append(env_reset(bench.train_classes[name], rows, 1.0)[1][:, 4:7].numpy())
    return seek_targets(np.asarray(env.obj_init_pos[:, 0]), np.concatenate(obs),
                        np.asarray(env.sim.obj_pos[:, 0]),
                        np.asarray(scene.obj_grasp_off)[:, 0],
                        np.asarray(scene.obj_exists)[:, 0] > 0, per_task)


def seek_batch(names, per_task=PER_TASK):
    """The reset batch with every slot parked 3 cm above its seek target.
    `check_control_step`'s seek policy steers to obj_init_pos, so the
    batch carries the targets there; the physics never reads it."""
    env, scene = reset_batch(per_task=per_task, names=names)
    target = batch_seek_targets(env, scene, names, per_task)
    goal = target + np.float32([0, 0, 0.03])
    env = env.replace(
        sim=env.sim.replace(mocap=jnp.asarray(goal - TCP_OFFSET),
                            hand=jnp.asarray(goal)),
        obj_init_pos=env.obj_init_pos.at[:, 0].set(jnp.asarray(target)))
    return env, scene


def _seen(sims, field, name, names, per_task=PER_TASK):
    """Slots of task `name` (of the batch of `names`) with `field` set at
    any step."""
    k = names.index(name)
    flags = np.stack([np.asarray(getattr(s, field))[k * per_task:(k + 1) * per_task]
                      for s in sims])
    return int(flags.reshape(len(sims), per_task, -1).any(axis=(0, 2)).sum())


def test_control_step_matches_jax_random():
    check_control_step("random", *reset_batch(per_task=PER_TASK, names=NEW))


@pytest.mark.parametrize("name", ["peg-unplug-side-v3", "hammer-v3"])
def test_seek_targets_reach_the_grasp_point(name):
    """The plug's end cap and the hammer's handle are where their grasps
    begin: the third kind of target is the center plus the grasp offset."""
    env, scene = reset_batch(per_task=PER_TASK, names=[name])
    target = batch_seek_targets(env, scene, [name], PER_TASK)
    off = np.asarray(scene.obj_grasp_off)[2, 0]
    assert np.abs(off).max() > 0
    np.testing.assert_allclose(target[2], np.asarray(env.sim.obj_pos)[2, 0] + off,
                               rtol=0, atol=1e-7)

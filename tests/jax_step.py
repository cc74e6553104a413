"""The JAX per-env step, `env_step`'s body (metaworld_tpu/envs/core.py:
207-238), with its physics and its `post_step` passed in, and the
tolerances within which two evaluations of one step must agree. Imports
only JAX, so that JAX-only tests can use it.

Tolerances: positions, quaternions, joints, flags and forces 1e-5,
velocities 1e-4 and gripper_vel 3e-4, each plus 1e-6 of the field's
magnitude; observations, the previous observation and rewards 1e-4.
"""

import jax
import jax.numpy as jnp

TOL = dict(hand_vel=1e-4, obj_vel=1e-4, obj_angvel=1e-4, joint_v=1e-4,
           gripper_vel=3e-4)
OUT_TOL = 1e-4


def guarded_tail(post, state, sim, act):
    """env_step's body after its physics: the non-finite guard on the new
    physics state `sim`, then `post` (post_step)."""
    stable = (jnp.isfinite(sim.hand).all() & jnp.isfinite(sim.obj_pos).all()
              & jnp.isfinite(sim.joint_q).all() & jnp.isfinite(sim.gripper).all())
    sim = jax.tree.map(lambda new, old: jnp.where(stable, new, old), sim, state.sim)
    state, out = post(state.replace(sim=sim, path_length=state.path_length + 1), act)
    return state, out.replace(
        reward=jnp.where(stable, out.reward, 0.0),
        unscaled_reward=jnp.where(stable, out.unscaled_reward, 0.0))


def guarded_step(physics, spec, post, state, act):
    """env_step's body with `physics(scene, sim, action)` for its physics
    and `post` for post_step."""
    act = jnp.asarray(act)
    return guarded_tail(post, state, physics(spec.scene_device, state.sim, act), act)

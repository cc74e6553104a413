"""The port's lane physics (the CUDA kernel's plain version) against the
JAX package's `engine_lanes.control_step`, on one batch that holds all ten
MT10 scenes.

Each step both sides restart from the shared JAX state, so a knife-edge
contact cannot fork the trajectories. Positions, quaternions, joint
coordinates, flags and forces are held at 1e-5 (test_engine_lanes.py's
tolerance). Velocity fields (hand_vel, gripper_vel, obj_vel, obj_angvel,
joint_v) are finite differences over the 2.5 ms substep, which multiplies a
one-ulp position difference by 400 (a 1-ulp hand difference at 0.6 m is
2.4e-5 m/s, and XLA fuses multiply-adds that PyTorch rounds separately), so
they are held at 1e-4; gripper_vel is the claw gap's difference over dt
divided by the 0.1 m full opening, 4000 times a gap ulp (3e-5 per ulp at
0.1 m), and is held at 3e-4. Every field also allows 1e-6 of its own
magnitude (pad forces reach 400 N, where an ulp is 3e-5).

XLA compiles the jitted JAX step with fused multiply-adds, and on rare
knife-edge contacts that alone flips a branch: the jitted and the eager
(`jax.disable_jit`) evaluation of the same JAX function then disagree. Where
the port disagrees with the jitted step on an env, that env's step is rerun
eagerly, the reference is required to disagree with itself there, and the
port is held to the eager result at the same tolerances. The reruns of a
check run as one eager batch after its steps: the lanes are independent,
and each eager call pays for every primitive's dispatch whatever its width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs.core import env_reset as j_env_reset
from metaworld_tpu.physics import engine_lanes as jlanes
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.physics import engine_lanes as tlanes
from metaworld_tpu_torch.types import tree_map

MT10 = jbench.MT10_LIST
TOL = dict(hand_vel=1e-4, obj_vel=1e-4, obj_angvel=1e-4, joint_v=1e-4,
           gripper_vel=3e-4)
TCP_OFFSET = np.array([0.0044, 0.0015, -0.0498], np.float32)


def reset_batch(per_task=3, near=False, names=None):
    """JAX reset states for `per_task` slots of every MT10 task (or of each
    task in `names`, from its MT1 goals). With `near`, the weld is parked
    3 cm above each slot's object or handle so the steps that follow make
    contact. The resets are made once per (per_task, names) and shared by
    a file's random and seek modes (JAX arrays, never written)."""
    env, scene = _resets(per_task, None if names is None else tuple(names))
    if near:
        goal = np.asarray(env.obj_init_pos[:, 0]) + np.float32([0, 0, 0.03])
        mocap = (goal - TCP_OFFSET).astype(np.float32)
        env = env.replace(sim=env.sim.replace(mocap=jnp.asarray(mocap),
                                              hand=jnp.asarray(goal)))
    return env, scene


@functools.lru_cache(maxsize=None)
def _resets(per_task, names):
    envs, scenes = [], []
    for n in names or MT10:
        bench = (jbench.MT1(n, seed=0, num_goals=per_task) if names
                 else _mt10(per_task))
        spec = bench.train_classes[n]
        table = bench.goal_table(n)
        for g in range(per_task):
            st, _ = j_env_reset(spec, jnp.asarray(table[g]),
                                jax.random.PRNGKey(g), 1.0)
            envs.append(st)
            scenes.append(spec.scene_device)
    env = jax.tree.map(lambda *x: jnp.stack(x), *envs)
    scene = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *scenes)
    return env, scene


@functools.lru_cache(maxsize=None)
def _mt10(per_task):
    return jbench.MT10(seed=0, num_goals=per_task)


def actions(rng, env, mode):
    """Random actions, or a seek policy toward each slot's object/handle
    that closes the grip once there."""
    n = env.sim.hand.shape[0]
    a = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    if mode == "seek":
        d = np.asarray(env.obj_init_pos[:, 0]) - np.asarray(env.sim.hand)
        a[:, :3] = np.clip(d * 60.0 + 0.3 * a[:, :3], -1, 1)
        a[:, 3] = np.where(np.linalg.norm(d, axis=1) < 0.03, 1.0, a[:, 3])
    return a


def bad_envs(sim_ref, sim_t):
    """{env index: (field, error)} where the port is outside tolerance."""
    dr, dt = convert.as_dict(sim_ref), convert.as_dict(sim_t)
    bad = {}
    for k in dr:
        ref = dr[k].astype(np.float64).reshape(dr[k].shape[0], -1)
        err = np.abs(ref - dt[k].astype(np.float64).reshape(ref.shape))
        over = err > TOL.get(k, 1e-5) + 1e-6 * np.abs(ref)
        for i in np.nonzero(over.any(axis=1))[0]:
            bad.setdefault(int(i), (k, float(err[i].max())))
    return bad


_step_jit = jax.jit(jlanes.control_step)


def check_control_step(mode, env, scene):
    """25 steps of the port's lane physics against the jitted JAX step,
    each from the JAX state, with the eager rerun rule of the docstring.
    The env steps outside tolerance are rerun eagerly together, in one
    batch after the 25 steps (the lanes are independent). Returns the JAX
    states after each step."""
    def step_j(s, a):
        return _step_jit(scene, s, a)
    scene_t = tree_map(lambda a: convert._tensor(a, "cpu"),
                       convert.scene_from_dict(convert.as_dict(scene)))
    rng = np.random.default_rng(0)
    sim = env.sim
    sims, flagged = [], []
    for t in range(25):
        act = actions(rng, env.replace(sim=sim), mode)
        sim_j = step_j(sim, jnp.asarray(act))
        sim_t = tlanes.control_step(
            scene_t, convert.sim_from_dict(convert.as_dict(sim), "cpu"),
            torch.from_numpy(act))
        for i, (field, err) in bad_envs(sim_j, sim_t).items():
            one = lambda tree: jax.tree.map(lambda x: x[i:i + 1], tree)  # noqa: E731
            flagged.append(dict(
                what=f"{mode} t={t} env {i}", field=field, err=err,
                scene=one(scene), sim=one(sim), act=act[i:i + 1],
                jitted=one(sim_j), port=tree_map(lambda x: x[i:i + 1], sim_t)))
        sim = sim_j
        sims.append(sim_j)
    if flagged:
        def cat(key):
            return jax.tree.map(lambda *x: jnp.concatenate(x),
                                *[f[key] for f in flagged])
        with jax.disable_jit():
            eager = jlanes.control_step(cat("scene"), cat("sim"),
                                        jnp.asarray(np.concatenate(
                                            [f["act"] for f in flagged])))
        for k, f in enumerate(flagged):
            sim_e = jax.tree.map(lambda x: x[k:k + 1], eager)
            assert bad_envs(sim_e, f["jitted"]), (
                f"{f['what']}: {f['field']} off by {f['err']:.3e}")
            assert not bad_envs(sim_e, f["port"]), (
                f"{f['what']}: port differs from eager JAX")
    return sims


@pytest.mark.parametrize("mode", ["random", "seek"])
def test_control_step_matches_jax(mode):
    check_control_step(mode, *reset_batch(near=mode == "seek"))


def test_reach_target_delta_matches_jax():
    rng = np.random.default_rng(1)
    lo, hi = np.float32([-0.6, 0.3, -0.1]), np.float32([0.6, 1.1, 0.6])
    p = rng.uniform(lo, hi, (4096, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jlanes.reach_target_delta)(jnp.asarray(p)))
    got = tlanes.reach_target_delta(torch.from_numpy(p)).numpy()
    assert np.abs(want).max() > 0.01  # the sample reaches the envelope
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_polynomial_atan2_matches_jax():
    th = np.linspace(-np.pi, np.pi, 721)[:-1]
    for r in (1e-3, 0.1, 1.0, 40.0):
        y = (r * np.sin(th)).astype(np.float32)
        x = (r * np.cos(th)).astype(np.float32)
        want = np.asarray(jlanes._atan2(jnp.asarray(y), jnp.asarray(x)))
        got = tlanes._atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
        exact = np.arctan2(y.astype(np.float64), x.astype(np.float64))
        assert np.max(np.abs(got - exact)) < 5e-6

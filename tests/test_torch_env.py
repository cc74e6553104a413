"""Per MT10 task: the port's reset and step tail (observation + reward)
against the JAX package's `env_reset` and `post_step`, and the reset's
independence of its random generator on every goal-table row.

States for the step tail are JAX reset states with seeded numpy
perturbations of the hand, gripper, objects, joints, pad forces, path
length and goal visibility, so the reward branches are crossed. Tolerances:
observations 1e-5 absolute; rewards and metrics 1e-5 relative or 1e-6
absolute; 0/1 flags exact.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs.core import env_reset as j_env_reset
from metaworld_tpu.envs.core import post_step as j_post_step
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.envs import core as tcore
from metaworld_tpu_torch.envs.tasks import common

MT10 = jbench.MT10_LIST
N_GOALS = 8
FLAGS = ("success", "grasp_success", "terminated", "truncated")


@functools.lru_cache(maxsize=None)
def _benches():
    return jbench.MT10(seed=0, num_goals=N_GOALS), tbench.MT10(seed=0, num_goals=N_GOALS)


def _jax_reset(name, jb=None):
    jb = jb or _benches()[0]
    spec = jb.train_classes[name]
    rows = jnp.asarray(jb.goal_table(name))
    keys = jax.random.split(jax.random.PRNGKey(0), rows.shape[0])
    return jax.jit(jax.vmap(lambda r, k: j_env_reset(spec, r, k, 1.0)))(rows, keys)


def _assert_tree_close(a, b, atol, path=""):
    if isinstance(a, dict):
        for k in a:
            _assert_tree_close(a[k], b[k], atol, path + "." + k)
        return
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               rtol=0, atol=atol, err_msg=path)


def check_reset(name, jb, tb):
    """The port's reset of every goal row of `tb` against the JAX reset of
    the same rows of `jb`."""
    state_j, obs_j = _jax_reset(name, jb)
    spec = tb.train_classes[name]
    rows = torch.from_numpy(tb.goal_table(name).astype(np.float32))
    state_t, obs_t = tcore.env_reset(spec, rows, 1.0)
    _assert_tree_close(convert.as_dict(state_j), convert.as_dict(state_t), 1e-6)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MT10)
def test_env_reset_matches_jax(name):
    check_reset(name, *_benches())


def _perturbed_states(name, seed=0, jb=None):
    """JAX reset states (N_GOALS x 4 slots) with seeded perturbations."""
    state, _ = _jax_reset(name, jb)
    state = jax.tree.map(lambda x: jnp.concatenate([x] * 4), state)
    d = convert.as_dict(state)
    n = d["path_length"].shape[0]
    rng = np.random.default_rng(seed)
    sim = d["sim"]
    near = rng.random(n) < 0.5
    anchor = np.where(near[:, None], d["obj_init_pos"][:, 0], sim["hand"])
    hand = anchor + rng.uniform(-0.04, 0.04, (n, 3))
    sim["hand"] = hand.astype(np.float32)
    sim["gripper"] = rng.uniform(0.0, 1.1, n).astype(np.float32)
    sim["obj_pos"] = (sim["obj_pos"] + rng.uniform(-0.05, 0.05, (n, 2, 3))
                      * (rng.random((n, 1, 1)) < 0.7)).astype(np.float32)
    sim["joint_q"] = (sim["joint_q"] + rng.uniform(-0.3, 0.3, (n, 2))
                      * (rng.random((n, 1)) < 0.7)).astype(np.float32)
    force = rng.uniform(0, 500, (n, 2)) * (rng.random((n, 2)) < 0.6)
    sim["pad_force_l"] = force[:, 0].astype(np.float32)
    sim["pad_force_r"] = force[:, 1].astype(np.float32)
    half = (sim["gripper"] * 0.1 - 0.006) / 2
    sim["pad_l"] = (hand + np.stack([0 * half, half, 0.045 + 0 * half], 1)).astype(np.float32)
    sim["pad_r"] = (hand + np.stack([0 * half, -half, 0.045 + 0 * half], 1)).astype(np.float32)
    d["path_length"] = rng.integers(0, 600, n).astype(np.int32)
    d["goal_visible"] = (rng.random(n) < 0.7).astype(np.float32)
    return d, rng.uniform(-1, 1, (n, 4)).astype(np.float32)


def check_post_step(name, jb, tb):
    """The port's step tail against the JAX `post_step` on perturbed JAX
    reset states of `name`."""
    d, act = _perturbed_states(name, jb=jb)
    spec_j = jb.train_classes[name]
    state_j, _ = _jax_reset(name, jb)
    state_j = jax.tree.map(lambda x: jnp.concatenate([x] * 4), state_j)
    rebuilt = state_j.replace(
        sim=state_j.sim.replace(**{k: jnp.asarray(v) for k, v in d["sim"].items()}),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "sim"})
    new_j, out_j = jax.jit(jax.vmap(functools.partial(j_post_step, spec_j)))(
        rebuilt, jnp.asarray(act))
    state_t = convert.env_from_dict(d, "cpu")
    new_t, out_t = tcore.post_step(tb.train_classes[name], state_t,
                                   torch.from_numpy(act))
    np.testing.assert_allclose(out_t.obs.numpy(), np.asarray(out_j.obs),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(new_t.prev_obs.numpy(), np.asarray(new_j.prev_obs),
                               rtol=0, atol=1e-5)
    for f in dataclasses.fields(out_t):
        if f.name == "obs":
            continue
        a = np.asarray(getattr(out_j, f.name))
        b = getattr(out_t, f.name).numpy()
        if f.name in FLAGS:
            np.testing.assert_array_equal(b.astype(np.float32), a.astype(np.float32),
                                          err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f.name)
    assert np.asarray(out_j.reward).std() > 0  # the states cross reward branches


@pytest.mark.parametrize("name", MT10)
def test_post_step_matches_jax(name):
    check_post_step(name, *_benches())


def check_reset_ignores_generator(spec, table):
    """Every row of the goal table passes the task's rejection test, so the
    masked resampling rounds of `sample_until` never replace one and a reset
    is a pure function of its goal row -- what the fused engine's reset table
    relies on."""
    name = spec.name
    rows = torch.from_numpy(table.astype(np.float32))
    module = importlib.import_module(
        "metaworld_tpu_torch.envs.tasks." + name.replace("-", "_")[:-3] + "_v3")
    good = getattr(module, "good", None)
    if good is not None:
        r = rows[:, : spec.rand_dim]
        assert bool(good(r).all())
        c = spec.consts("cpu")
        kept = common.sample_until(good, r, torch.Generator().manual_seed(1),
                                   c.rand_low, c.rand_high)
        assert torch.equal(kept, r)
    outs = []
    for seed in (1, 2):
        st, obs = tcore.env_reset(spec, rows, 1.0, torch.Generator().manual_seed(seed))
        outs.append((convert.as_dict(st), obs.numpy()))
    _assert_tree_close(outs[0][0], outs[1][0], 0.0)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("name", MT10)
def test_reset_ignores_generator_on_goal_rows(name):
    _, tb = _benches()
    check_reset_ignores_generator(tb.train_classes[name],
                                  tbench.MT10(seed=42).goal_table(name))

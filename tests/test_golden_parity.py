"""Generic parity tests against the golden reference traces, parametrized
over every implemented task. New task modules get covered automatically.

The closed-loop cases run `env_step` as its two halves, on the pattern of
test_torch_env_step_a.py: the physics, `engine.control_step`, jitted once
for every task (the scene is an argument), and the step's tail (the
non-finite guard and `post_step`: tests/jax_step.py's `guarded_tail`,
env_step's body at metaworld_tpu/envs/core.py:207-238) jitted per task.
Jitting the whole step per task, as one `lax.scan` over 500 steps did,
compiled the physics anew for each of the 50 tasks. On the first and the
last step, `env_step` itself, jitted, must agree with the two halves
within tests/jax_step.py's tolerances, and the rollout goes on from
env_step's state. Tier-1 makes that check on the tasks of CHECKED, one of
each scene kind (objects only, fixture only, both; test_engine_lanes.py's
TASKS); `test_closed_loop_matches_env_step` (slow) makes it on every task.
Checking every task would bring back what the halves save: jitting
env_step costs a task about 6 s on one CPU core (2.5-3.4 s to trace,
2.4-3.9 s to compile), the old scan about 9.5 s, a task's whole rollout
on the halves about 2.5 s. The halves are the same for every task:
`guarded_tail` is env_step's task-independent body around the task's own
`post_step`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metaworld_tpu.envs import registry
from metaworld_tpu.envs.core import env_reset, env_step, post_step
from metaworld_tpu.physics import engine
from metaworld_tpu.policies import get_policy, implemented_policies
from tests.jax_step import OUT_TOL, TOL, guarded_tail

STEPS = 500
CHECKED = ("pick-place-v3", "door-open-v3", "hammer-v3")

_control = jax.jit(engine.control_step)


def _implemented():
    return registry.implemented_envs()


@pytest.mark.parametrize("name", implemented_policies())
def test_policy_parity(name, golden):
    """Our branchless policy must reproduce the reference policy's actions on
    the reference's own observations. Near decision boundaries f32 vs f64 can
    flip a branch, so we demand 98% of steps agree tightly.

    (The golden generator passes the reference policies a COPY of the obs —
    the two door policies mutate the obs array in place through numpy views,
    ref sawyer_door_close_v3_policy.py:40 — so the recorded obs are pristine.)
    """
    d = golden(name)
    pol = jax.jit(jax.vmap(get_policy(name)))
    obs_in = d["obs"]
    ours = np.asarray(pol(jnp.asarray(obs_in)))
    ref = d["action"]
    err = np.abs(ours - ref).max(axis=1)
    frac_bad = float((err > 1e-4).mean())
    assert frac_bad < 0.02, f"{name}: {frac_bad:.1%} of steps mismatch (max {err.max():.4f})"


def _assert_same_step(name, t, ref, got):
    """(state, out) of env_step against the two halves' (state, out)."""
    ref_leaves, _ = jax.tree_util.tree_flatten_with_path(ref)
    for (path, r), g in zip(ref_leaves, jax.tree.leaves(got)):
        where = jax.tree_util.keystr(path)
        field = where.rsplit(".", 1)[-1]
        if ".sim." in where:
            tol, rel = TOL.get(field, 1e-5), 1e-6
        elif where.startswith("[1]") or field == "prev_obs":
            tol, rel = OUT_TOL, 0.0
        else:
            tol, rel = 0.0, 0.0
        r, g = np.asarray(r, np.float64), np.asarray(g, np.float64)
        err = np.abs(r - g)
        assert (err <= tol + rel * np.abs(r)).all(), \
            f"{name} t={t}: {where} off by {err.max():.3e}"


def _closed_loop(name, golden, checked):
    """The scripted expert's 500 steps from the golden task vector; on the
    first and last, when `checked`, env_step itself against the halves."""
    d = golden(name)
    spec = registry.get_spec(name)
    rand = np.zeros(12)
    rv = d["attr_last_rand_vec"]
    rand[: rv.shape[0]] = rv
    policy = jax.jit(get_policy(name))
    tail = jax.jit(functools.partial(guarded_tail, functools.partial(post_step, spec)))
    whole = jax.jit(functools.partial(env_step, spec)) if checked else None
    reset = jax.jit(lambda rand_vec, key: env_reset(spec, rand_vec, key, goal_visible=1.0))

    state, obs = reset(jnp.asarray(rand), jax.random.PRNGKey(0))
    success = jnp.zeros(())
    for t in range(STEPS):
        action = policy(obs)
        new = tail(state, _control(spec.scene_device, state.sim, action), action)
        if whole is not None and t in (0, STEPS - 1):
            ref = whole(state, action)
            _assert_same_step(name, t, ref, new)
            new = ref
        state, out = new
        obs, success = out.obs, jnp.maximum(success, out.success)
    assert float(success) == 1.0, f"{name}: scripted policy failed on our engine"


@pytest.mark.parametrize("name", _implemented())
def test_closed_loop_success(name, golden):
    """The scripted expert must solve the task on OUR engine with the golden
    task vector — the reference's behavioral gold standard
    (ref tests/.../test_scripted_policies.py asserts >= 0.80 over 50 goals;
    here: the recorded goal must succeed)."""
    missing = set(CHECKED) - set(_implemented())
    assert not missing, f"CHECKED names tasks that are not implemented: {missing}"
    _closed_loop(name, golden, checked=name in CHECKED)


@pytest.mark.slow
@pytest.mark.parametrize("name", _implemented())
def test_closed_loop_matches_env_step(name, golden):
    """test_closed_loop_success with env_step checked against the halves on
    every task, not only those of CHECKED.

    Slow (about 10 s a task, 510 s for the 50 on one CPU core): the jit of
    env_step per task is the cost the halves save; test_closed_loop_success
    makes the same check on CHECKED in tier-1."""
    _closed_loop(name, golden, checked=True)


@pytest.mark.parametrize("name", _implemented())
def test_obs_layout(name, golden):
    """Obs layout invariants (ref tests/helpers.py:4-33): hand, gripper,
    object block, frame stack, goal."""
    d = golden(name)
    spec = registry.get_spec(name)
    rand = np.zeros(12)
    rv = d["attr_last_rand_vec"]
    rand[: rv.shape[0]] = rv
    state, obs = env_reset(spec, jnp.asarray(rand), jax.random.PRNGKey(0), 1.0)
    obs = np.asarray(obs)
    assert obs.shape == (39,)
    ref0 = d["obs0"]
    np.testing.assert_allclose(obs[:3], ref0[:3], atol=8e-3)
    assert 0.0 <= obs[3] <= 1.0
    # object block: within 2 cm of the reference at reset.
    # window-close is exempt: the reference's reset observation reads the
    # handle site BEFORE mj_forward, so its obs0 reflects the stale q=0
    # pose (off by the full 0.2 slide); ours is fresh.
    if name != "window-close-v3":
        np.testing.assert_allclose(obs[4:7], ref0[4:7], atol=2e-2)
    np.testing.assert_allclose(obs[18:36], obs[:18], atol=0)
    # goal: reference pins target z to the settled obj geom height (~2.7e-5
    # below the nominal 0.02 for pucks), so allow sub-mm slack
    np.testing.assert_allclose(obs[36:39], ref0[36:39], atol=5e-4)

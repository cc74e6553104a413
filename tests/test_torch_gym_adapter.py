"""The port's single-env Gymnasium facade (`metaworld_tpu_torch.gym_adapter.
SawyerEnv`) on the CPU: the cases of tests/test_gym_adapter.py on the port,
held against the JAX package where it computes the same thing. The expert
reaches success; step before set_task or a seed raises; truncation; a
seeded env replays gymnasium's `np_random(seed)` stream bit for bit (the
same goal vectors as the JAX env); snapshots and pickling restore bit for
bit; goal hidden / observable; reset and the first steps agree with the
JAX env's within the reset's tolerance (1e-6, test_torch_env.py) and the
per-env step's (1e-4, test_torch_env_step_a.py).
test_torch_gym_render.py holds rendering and the vector facade.
"""

import pickle

import numpy as np
import pytest
import torch

import metaworld_tpu as jmw
import metaworld_tpu_torch as mw
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.policies import get_policy
from metaworld_tpu_torch.types import MAX_RAND


def _env(name, seed=0, **kw):
    env = mw.SawyerEnv(name, seed=seed, device="cpu", **kw)
    env.set_task(mw.MT1(name, seed=seed, num_goals=1).train_tasks[0])
    return env


def test_single_env_api():
    env = mw.SawyerEnv("reach-v3", seed=42, device="cpu")
    env.set_task(mw.MT1("reach-v3", seed=42).train_tasks[0])
    obs, info = env.reset()
    assert obs.shape == (39,) and obs.dtype == np.float64
    pol = get_policy("reach-v3")
    success = 0.0
    for _ in range(120):
        act = pol(torch.from_numpy(obs[None].astype(np.float32)))[0].numpy()
        obs, r, term, trunc, info = env.step(act)
        assert set(info) == {"success", "near_object", "grasp_success",
                             "grasp_reward", "in_place_reward",
                             "obj_to_target", "unscaled_reward"}
        success = max(success, info["success"])
        if success:
            break
    assert success == 1.0


def test_reset_and_steps_match_the_jax_env():
    """Reset observations within test_torch_env.py's reset tolerance
    (1e-6); five steps of the same actions within the per-env step's
    (1e-4)."""
    task = mw.MT1("push-v3", seed=3, num_goals=1).train_tasks[0]
    jenv = jmw.SawyerEnv("push-v3", seed=3)
    jenv.set_task(jmw.MT1("push-v3", seed=3, num_goals=1).train_tasks[0])
    env = mw.SawyerEnv("push-v3", seed=3, device="cpu")
    env.set_task(task)
    np.testing.assert_allclose(env.reset()[0], jenv.reset()[0], rtol=0, atol=1e-6)
    # the JAX env's unbatched state as a 1-slot port state
    carried = convert.env_from_single_dict(convert.as_dict(jenv._state), "cpu")
    for k, v in convert.as_dict(carried)["sim"].items():
        np.testing.assert_allclose(v, convert.as_dict(env._state)["sim"][k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert carried.rand_vec.shape == (1, MAX_RAND)
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = rng.uniform(-1, 1, 4).astype(np.float32)
        o, r, te, tr, info = env.step(a)
        jo, jr, jte, jtr, jinfo = jenv.step(a)
        np.testing.assert_allclose(o, jo, rtol=0, atol=1e-4)
        assert abs(r - jr) <= 1e-4 and (te, tr) == (jte, jtr)
        for k in info:
            assert abs(info[k] - jinfo[k]) <= 1e-4, k


def test_step_before_task_raises():
    env = mw.SawyerEnv("push-v3", device="cpu")
    with pytest.raises(RuntimeError):
        env.step(np.zeros(4))


def test_v1_rewards_are_not_ported():
    with pytest.raises(NotImplementedError, match="A14"):
        mw.SawyerEnv("push-v3", device="cpu", reward_function_version="v1")
    with pytest.raises(NotImplementedError, match="A14"):
        mw.vector.from_benchmark(mw.MT1("push-v3", seed=0, num_goals=1),
                                 reward_function_version="v1", device="cpu")


def test_truncation_enforced():
    env = mw.SawyerEnv("reach-v3", seed=0, device="cpu")
    env.reset()
    env.max_path_length = 3
    for _ in range(3):
        obs, r, te, tr, info = env.step(np.zeros(4))
    assert env.curr_path_length == 3
    with pytest.raises(ValueError):
        env.step(np.zeros(4))


def test_seeded_env_replays_reference_rng_stream():
    """A seeded env without set_task draws its goals from gymnasium's
    np_random(seed) stream with the reference's double reset_model +
    rejection structure (ref sawyer_xyz_env.py:664-682,697-710): bit for
    bit the JAX env's goal vectors."""
    from gymnasium.utils import seeding

    from metaworld_tpu_torch.benchmarks import _rejects

    for name in ("reach-v3", "pick-place-v3", "assembly-v3"):
        env = mw.SawyerEnv(name, seed=123, device="cpu")
        jenv = jmw.SawyerEnv(name, seed=123)
        spec = registry.get_spec(name)
        rng, _ = seeding.np_random(123)

        def ref_draw():
            v = rng.uniform(spec.rand_low, spec.rand_high, size=spec.rand_low.size)
            while _rejects(name, v):
                v = rng.uniform(spec.rand_low, spec.rand_high,
                                size=spec.rand_low.size)
            return v

        for _ in range(3):
            ref_draw()
            expect = ref_draw()          # the second reset_model call wins
            obs, _ = env.reset()
            jobs, _ = jenv.reset()
            got = env._state.rand_vec[0].numpy()
            np.testing.assert_array_equal(got[: expect.shape[0]],
                                          expect.astype(np.float32))
            np.testing.assert_array_equal(got, np.asarray(jenv._state.rand_vec))
            np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-6)


def test_env_state_snapshot_and_pickle():
    """get_env_state / set_env_state restore an exact mid-episode state, and
    the whole env pickles (ref SawyerMocapBase :87-131)."""
    env = _env("push-v3", seed=9)
    env.reset()
    for _ in range(8):
        env.step(np.array([0.4, 0.2, -0.3, 1.0]))
    snap = env.get_env_state()
    obs_a, r_a, *_ = env.step(np.array([0.1, 0.1, 0.0, 1.0]))
    env.set_env_state(snap)
    assert env.curr_path_length == 8
    obs_b, r_b, *_ = env.step(np.array([0.1, 0.1, 0.0, 1.0]))
    np.testing.assert_array_equal(obs_a, obs_b)
    assert r_a == r_b

    env.set_env_state(snap)
    clone = pickle.loads(pickle.dumps(env))
    obs_c, r_c, *_ = clone.step(np.array([0.1, 0.1, 0.0, 1.0]))
    np.testing.assert_array_equal(obs_a, obs_c)
    assert r_a == r_c and clone.curr_path_length == 9


def test_goal_hidden_observable():
    h = mw.make_goal_hidden("pick-place-v3", seed=5, device="cpu")
    obs, _ = h.reset()
    np.testing.assert_array_equal(obs[36:39], 0.0)
    o = mw.make_goal_observable("pick-place-v3", seed=5, device="cpu")
    obs2, _ = o.reset()
    assert np.abs(obs2[36:39]).sum() > 0
    obs3, *_ = h.step(np.zeros(4))
    np.testing.assert_array_equal(obs3[36:39], 0.0)

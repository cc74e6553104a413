"""The v1 reward family through the port's entry points:
`vector.from_benchmark(..., reward_function_version="v1")` (fused and
grouped), `registry.get_spec(name, "v1")` and
`SawyerEnv(..., reward_function_version="v1")`, against the JAX package.

The fused MT10 engine runs the port's plain physics against the JAX fused
engine (`physics="lanes"`), two slots per task, pinned goal rows
(`task_select="pseudorandom"`) and 4-step episodes, so every slot crosses
NEXT_STEP autoreset twice; each step restarts the port from the JAX state
(`convert`). Observations are held at 1e-5 (test_torch_fused.py); flags,
counters and success exactly; rewards and returns within
1e-5 * max(1, |jax|) and the other metrics within 1e-6 * max(1, |jax|),
test_torch_v1_rewards.py's tolerances. The per-env facade is held as
test_torch_gym_adapter.py holds the v2 env, each step from the JAX env's
state, on two tasks outside MT10 whose v1 rewards read more than the
observation's first block (the nut COM; the hammer head from the live
quaternion).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaworld_tpu as jmw
import metaworld_tpu_torch as mw
from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu.envs import registry as jregistry
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert, vector
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.rewards.v1 import V1_REWARDS

KW = dict(one_hot=True, max_episode_steps=4, task_select="pseudorandom")
EXACT = ("terminated", "truncated", "done", "episode_length", "success",
         "grasp_success")
REWARD_LIKE = ("reward", "episode_return", "unscaled_reward")


def _close_v1(got, ref, where, key):
    """test_torch_v1_rewards.py's tolerances: rewards and returns within
    1e-5 * max(1, |jax|), every other metric within 1e-6 * max(1, |jax|)."""
    rtol = 1e-5 if key in REWARD_LIKE else 1e-6
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert np.all(err <= rtol * np.maximum(1.0, np.abs(ref))), (
        f"{where}: off by {err.max():.3e}")


def _compare_out(oj, ot, where):
    assert set(ot) == set(oj) == set(vector.OUT_KEYS)
    for k in oj:
        a, b = np.asarray(oj[k]), ot[k].numpy()
        assert a.shape == b.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(b.astype(np.float64),
                                          a.astype(np.float64),
                                          err_msg=f"{where}: {k}")
        elif k == "obs":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=where)
        else:
            _close_v1(b, a, f"{where}: {k}", k)


def test_fused_mt10_v1_matches_jax():
    jb, tb = jbench.MT10(seed=0, num_goals=5), tbench.MT10(seed=0, num_goals=5)
    je = jvector.from_benchmark(jb, envs_per_task=2, physics="lanes",
                                reward_function_version="v1", **KW)
    te = vector.from_benchmark(tb, envs_per_task=2, device="cpu",
                               reward_function_version="v1", **KW)
    assert [s.reward_fn for s in te.specs] == [V1_REWARDS[n] for n in te.task_names]
    step_j = jax.jit(je._step_impl)
    rng = np.random.default_rng(0)
    gidx = rng.integers(0, 5, te.num_envs).astype(np.int32)
    sj, oj = je._reset_jit(jax.random.PRNGKey(0), jnp.asarray(gidx))
    _, ot = te.reset(goal_idx=torch.from_numpy(gidx))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    resets = 0
    for t in range(10):
        # drive toward each slot's object half the time, so the gated
        # v1 bonuses fire
        act = rng.uniform(-1, 1, (te.num_envs, 4)).astype(np.float32)
        if t % 2:
            d = np.asarray(sj.env.obj_init_pos[:, 0] - sj.env.sim.hand)
            act[:, :3] = np.clip(d * 60.0, -1, 1)
        st = convert.fused_from_dict(convert.as_dict(sj), "cpu")
        resets += int(np.asarray(sj.pending_reset).sum())
        sj, out_j = step_j(sj, jnp.asarray(act))
        _, out_t = te.step(st, torch.from_numpy(act))
        _compare_out(out_j, out_t, f"t={t}")
    assert resets >= 2 * te.num_envs  # every slot crossed autoreset twice


def test_grouped_v1_engine_takes_the_v1_specs():
    tb = tbench.MT1("push-v3", seed=3, num_goals=5)
    envs = vector.from_benchmark(tb, envs_per_task=4, fused=False,
                                 reward_function_version="v1", device="cpu")
    assert isinstance(envs, vector.BatchedEnvs)
    assert envs.specs[0] is registry.get_spec("push-v3", "v1")
    state, obs = envs.reset()
    state, out = envs.step(state, torch.zeros(envs.num_envs, 4))
    # v1 push reward with no bonus is -reachDist (small negative)
    assert out["reward"].shape == (4,) and bool((out["reward"] < 0.5).all())


def test_get_spec_v1_is_cached_and_checked():
    for name in registry.ALL_V3_ENVIRONMENTS:
        v2, v1 = registry.get_spec(name), registry.get_spec(name, "v1")
        assert v1.reward_fn is V1_REWARDS[name]
        assert v2.reward_fn is not v1.reward_fn and v1.name == v2.name
        assert registry.get_spec(name, reward_function_version="v1") is v1
        assert registry.get_spec(name) is v2
    with pytest.raises(ValueError):
        registry.get_spec("reach-v3", "v0")
    with pytest.raises(KeyError):
        registry.get_spec("nope-v3", "v1")


@pytest.mark.parametrize("name", ["assembly-v3", "hammer-v3"])
def test_sawyer_env_v1_matches_jax(name):
    jenv = jmw.SawyerEnv(name, seed=3, reward_function_version="v1")
    jenv.set_task(jmw.MT1(name, seed=3, num_goals=1).train_tasks[0])
    env = mw.SawyerEnv(name, seed=3, device="cpu", reward_function_version="v1")
    env.set_task(mw.MT1(name, seed=3, num_goals=1).train_tasks[0])
    assert env.spec_ is registry.get_spec(name, "v1")
    assert jenv.spec_ is jregistry.get_spec(name, "v1")
    np.testing.assert_allclose(env.reset()[0], jenv.reset()[0], rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    for t in range(6):
        env._state = convert.env_from_single_dict(convert.as_dict(jenv._state), "cpu")
        a = rng.uniform(-1, 1, 4).astype(np.float32)
        o, r, te, tr, info = env.step(a)
        jo, jr, jte, jtr, jinfo = jenv.step(a)
        np.testing.assert_allclose(o, jo, rtol=0, atol=1e-4)
        _close_v1(r, jr, f"t={t} reward", "reward")
        assert (te, tr) == (jte, jtr)
        for k in info:
            _close_v1(info[k], jinfo[k], f"t={t} {k}", k)


def test_sawyer_env_v1_snapshot_and_pickle_keep_the_version():
    env = mw.SawyerEnv("push-v3", seed=9, device="cpu",
                       reward_function_version="v1")
    env.set_task(mw.MT1("push-v3", seed=9, num_goals=1).train_tasks[0])
    env.reset()
    for _ in range(4):
        env.step(np.array([0.4, 0.2, -0.3, 1.0]))
    snap = env.get_env_state()
    obs_a, r_a, *_ = env.step(np.array([0.1, 0.1, 0.0, 1.0]))
    env.set_env_state(snap)
    clone = pickle.loads(pickle.dumps(env))
    assert clone.reward_function_version == "v1"
    assert clone.spec_ is registry.get_spec("push-v3", "v1")
    obs_c, r_c, *_ = clone.step(np.array([0.1, 0.1, 0.0, 1.0]))
    np.testing.assert_array_equal(obs_a, obs_c)
    assert r_a == r_c


def test_every_task_steps_with_v1():
    """All 50 tasks build and step with the v1 family through
    `from_benchmark` (fused and grouped, MT50) and `SawyerEnv`: finite
    rewards from the v1 functions."""
    bench = tbench.MT50(seed=0, num_goals=1)
    for fused in (True, False):
        envs = vector.from_benchmark(bench, fused=fused, device="cpu",
                                     reward_function_version="v1")
        assert [s.reward_fn for s in envs.specs] == [
            V1_REWARDS[n] for n in envs.task_names]
        state, _ = envs.reset()
        _, out = envs.step(state, torch.zeros(envs.num_envs, 4))
        assert out["reward"].shape == (50,)
        assert bool(torch.isfinite(out["reward"]).all())
    for name in registry.ALL_V3_ENVIRONMENTS:
        env = mw.SawyerEnv(name, seed=0, device="cpu",
                           reward_function_version="v1")
        env.set_task(mw.MT1(name, seed=0, num_goals=1).train_tasks[0])
        env.reset()
        _, r, *_ = env.step(np.zeros(4))
        assert np.isfinite(r), name

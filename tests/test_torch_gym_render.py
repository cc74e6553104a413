"""The port's renderer and Gymnasium vector facade on the CPU, against the
JAX package's: the top view equals the JAX rasterizer bit for bit on all
50 tasks from the same (perturbed) state; the perspective cameras and
depth on three tasks; `SawyerEnv.render`'s modes; `register_mw_envs`
with gym.make / gym.make_vec; `GymVectorBatch`'s numpy outputs,
final_info and sample_tasks protocol.
"""

import types

import gymnasium as gym
import numpy as np
import pytest
import torch

import metaworld_tpu_torch as mw
from metaworld_tpu.envs import registry as jreg
from metaworld_tpu.render import render_camera as j_render_camera
from metaworld_tpu.render import render_state as j_render_state
from metaworld_tpu_torch import gym_adapter
from metaworld_tpu_torch.envs import core as tcore
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.render import render_camera, render_state
from metaworld_tpu_torch.types import MAX_RAND


def _env(name, seed=0, **kw):
    env = mw.SawyerEnv(name, seed=seed, device="cpu", **kw)
    env.set_task(mw.MT1(name, seed=seed, num_goals=1).train_tasks[0])
    return env


def _perturbed_states():
    """The port's reset state of every task at its first MT1(seed=0) goal,
    with seeded moves of the hand, gripper, objects (position and
    orientation) and joints, so rotated objects and turned handles are
    drawn. Returns [(name, 1-slot EnvState)]."""
    rng = np.random.default_rng(0)
    out = []
    for name in registry.ALL_V3_ENVIRONMENTS:
        spec = registry.get_spec(name)
        vec = mw.MT1(name, seed=0, num_goals=1).train_tasks[0].rand_vec
        rand = np.zeros((1, MAX_RAND), np.float32)
        rand[0, : vec.shape[0]] = vec
        st, _ = tcore.env_reset(spec, torch.from_numpy(rand), 1.0)
        q = rng.normal(size=(1, 2, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        sim = st.sim.replace(
            hand=st.sim.hand + torch.from_numpy(rng.uniform(-0.05, 0.05, (1, 3)).astype(np.float32)),
            gripper=torch.from_numpy(rng.uniform(0, 1, 1).astype(np.float32)),
            obj_pos=st.sim.obj_pos + torch.from_numpy(rng.uniform(-0.05, 0.05, (1, 2, 3)).astype(np.float32)),
            obj_quat=torch.from_numpy(q),
            joint_q=st.sim.joint_q + torch.from_numpy(rng.uniform(-0.3, 0.3, (1, 2)).astype(np.float32)))
        out.append((name, st.replace(sim=sim)))
    return out


def _jax_view(state):
    """Slot 0 of a port EnvState as the attribute tree the JAX renderer
    reads (numpy float32 fields)."""
    host = state.map(lambda t: t[0].numpy())
    return types.SimpleNamespace(
        target=host.target, sim=types.SimpleNamespace(**vars(host.sim)))


def test_render_topview_matches_jax_on_all_tasks():
    """The top view equals the JAX rasterizer bit for bit on every scene
    from the same state, and draws something."""
    for name, st in _perturbed_states():
        img = render_state(registry.get_spec(name), st)
        ref = j_render_state(jreg.get_spec(name), _jax_view(st))
        assert img.shape == (480, 480, 3) and img.dtype == np.uint8, name
        np.testing.assert_array_equal(img, ref, err_msg=name)
        assert (img != 235).any(), f"{name}: blank render"


@pytest.mark.parametrize("name", ["push-v3", "hammer-v3", "door-open-v3"])
def test_render_cameras_and_depth_match_jax(name):
    """The six perspective cameras, rgb and depth, at a custom size: equal
    to the JAX ray caster from the same state (rgb bit for bit; depth
    within 1e-5 m)."""
    st = dict(_perturbed_states())[name]
    spec, jspec, view = registry.get_spec(name), jreg.get_spec(name), _jax_view(st)
    for cam in ("corner", "corner2", "corner3", "corner4", "behindGripper",
                "gripperPOV"):
        img = render_camera(spec, st, cam, width=160, height=120)
        assert img.shape == (120, 160, 3) and img.dtype == np.uint8, cam
        assert img.std() > 1, f"{cam}: blank render"
        np.testing.assert_array_equal(
            img, j_render_camera(jspec, view, cam, width=160, height=120),
            err_msg=cam)
        d = render_camera(spec, st, cam, width=160, height=120, depth=True)
        assert d.shape == (120, 160) and d.dtype == np.float32, cam
        assert float(d.max()) > 0.1, cam
        np.testing.assert_allclose(
            d, j_render_camera(jspec, view, cam, width=160, height=120, depth=True),
            rtol=0, atol=1e-5, err_msg=cam)


def test_env_render_modes(tmp_path, monkeypatch):
    """SawyerEnv.render: rgb_array (topview at a custom size), depth_array
    (topview falls back to the corner camera) and human, which without a
    display writes frames under ./renders/<env>/."""
    env = _env("pick-place-v3", seed=7, render_mode="rgb_array", width=96,
               height=64)
    env.reset()
    img = env.render()
    assert img.shape == (64, 96, 3) and img.dtype == np.uint8 and img.std() > 1
    denv = _env("pick-place-v3", seed=7, render_mode="depth_array", width=96,
                height=64)
    denv.reset()
    d = denv.render()
    assert d.shape == (64, 96) and d.dtype == np.float32 and float(d.max()) > 0.1
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    henv = _env("pick-place-v3", seed=7, render_mode="human", width=32, height=32)
    henv.reset()
    assert henv.render() is None and henv.render() is None
    frames = sorted(p.name for p in (tmp_path / "renders" / "pick-place-v3").iterdir())
    assert [f.split(".")[0] for f in frames] == ["000000", "000001"]


@pytest.fixture
def gym_ids():
    """Takes the Meta-World IDs out of gymnasium's process-wide registry
    for the test and puts back what was there after it: the JAX package
    registers the same IDs, and its tests may run in the same process."""
    saved = {k: v for k, v in gym.registry.items() if k.startswith("Meta-World/")}

    def clear():
        for k in [k for k in gym.registry if k.startswith("Meta-World/")]:
            del gym.registry[k]

    clear()
    yield
    clear()
    gym.registry.update(saved)


def test_registration_and_make_vec(gym_ids):
    """register_mw_envs registers the reference's IDs, taking them over
    from the JAX package's registration; gym.make gives a SawyerEnv,
    gym.make_vec a GymVectorBatch over the fused engine."""
    import metaworld_tpu as jmw

    jmw.register_mw_envs()
    mw.register_mw_envs()
    ids = ["Meta-World/MT1", "Meta-World/goal_hidden", "Meta-World/goal_observable",
           "Meta-World/MT10", "Meta-World/MT25", "Meta-World/MT50",
           "Meta-World/custom-mt-envs", "Meta-World/custom-ml-envs"]
    ids += [f"Meta-World/{b}-{s}" for b in ("ML1", "ML10", "ML25", "ML45")
            for s in ("train", "test")]
    assert set(ids) <= set(gym.registry)
    env = gym.make("Meta-World/MT1", env_name="reach-v3", seed=3,
                   device="cpu").unwrapped
    assert isinstance(env, mw.SawyerEnv) and env.reset()[0].shape == (39,)
    hidden = gym.make("Meta-World/goal_hidden", env_name="reach-v3", seed=3,
                      device="cpu").unwrapped
    np.testing.assert_array_equal(hidden.reset()[0][36:], 0.0)

    vec = gym.make_vec("Meta-World/MT10", seed=0, envs_per_task=2,
                       use_one_hot=True, num_goals=3, device="cpu")
    assert isinstance(vec, gym_adapter.GymVectorBatch) and vec.num_envs == 20
    obs, _ = vec.reset()
    assert obs.shape == (20, 49) and isinstance(obs, np.ndarray)
    assert vec.get_attr("task_name")[::2] == mw.benchmarks.MT10_LIST
    obs, rew, term, trunc, info = vec.step(np.zeros((20, 4)))
    assert rew.shape == term.shape == trunc.shape == (20,)
    np.testing.assert_array_equal(info["final_info"]["success"], info["success"])

    ml = gym.make_vec("Meta-World/ML10-test", seed=0, meta_batch_size=5,
                      num_goals=3, device="cpu")
    assert ml.num_envs == 5 and ml.get_attr("terminate_on_success") == [True] * 5
    np.testing.assert_array_equal(ml.reset()[0][:, 36:39], 0.0)
    custom = gym.make_vec("Meta-World/custom-mt-envs",
                          envs_list=["reach-v3", "push-v3"], seed=1, device="cpu")
    assert custom.get_attr("task_name") == ["reach-v3", "push-v3"]
    cml = gym.make_vec("Meta-World/custom-ml-envs", train_envs=["reach-v3"],
                       test_envs=["push-v3"], seed=1, split="test", device="cpu")
    assert cml.get_attr("task_name") == ["push-v3"]


def test_vector_batch_matches_its_engine():
    """GymVectorBatch's numpy outputs are its engine's outputs on the same
    actions, from the same seeded reset; toggle_terminate_on_success flips
    the engine's flag."""
    mk = dict(seed=4, envs_per_task=2, num_goals=3, max_episode_steps=3,
              device="cpu")
    batch = gym_adapter.GymVectorBatch(mw.make_mt_envs("MT10", **mk), seed=11)
    eng = mw.make_mt_envs("MT10", **mk)
    obs, _ = batch.reset()
    state, obs_t = eng.reset(seed=11)
    np.testing.assert_array_equal(obs, obs_t.numpy())
    rng = np.random.default_rng(0)
    for _ in range(4):  # crosses the autoreset at 3 steps
        a = rng.uniform(-1, 1, (20, 4)).astype(np.float32)
        obs, rew, term, trunc, info = batch.step(a)
        state, out = eng.step(state, torch.from_numpy(a))
        np.testing.assert_array_equal(obs, out["obs"].numpy())
        np.testing.assert_array_equal(rew, out["reward"].numpy())
        np.testing.assert_array_equal(trunc, out["truncated"].numpy())
        np.testing.assert_array_equal(info["final_info"]["episode"]["r"],
                                      out["episode_return"].numpy())
    batch.call("toggle_terminate_on_success", True)
    assert batch.envs.terminate_on_success is True
    assert batch.get_attr("terminate_on_success") == [True] * 20


def test_facade_sample_tasks_protocol():
    """GymVectorBatch speaks the reference meta-eval call surface:
    toggle_sample_tasks_on_reset(False) + sample_tasks() pins goals per
    round, resets (autoreset included) keep them (ref evaluation.py:
    114-125)."""
    envs = mw.make_ml_envs_test("reach-v3", seed=0, meta_batch_size=2,
                                max_episode_steps=4, device="cpu")
    batch = gym_adapter.GymVectorBatch(envs, seed=0)
    batch.reset()
    batch.call("toggle_sample_tasks_on_reset", False)
    batch.call("sample_tasks")
    batch.reset()
    g1 = batch._state.env.rand_vec.clone()
    for _ in range(6):  # crosses the autoreset after 4 steps
        batch.step(np.zeros((batch.num_envs, 4)))
    torch.testing.assert_close(g1, batch._state.env.rand_vec, rtol=0, atol=0)
    batch.call("sample_tasks")
    batch.reset()
    assert not torch.equal(g1, batch._state.env.rand_vec)
    with pytest.raises(AttributeError):
        batch.call("no_such_method")

"""Gymnasium-compatible adapter and public env factories (counterpart of
`metaworld_tpu/gym_adapter.py`, ref metaworld/__init__.py:460-823).

- `SawyerEnv`: the reference's single-env step/reset/set_task API over
  `envs.core.env_step` at n = 1 (the kernel on a CUDA device, the plain
  lane engine on the CPU), with `render`,
  snapshots and pickling; `make_goal_hidden` / `make_goal_observable`.
- `make_mt_envs` and `make_ml_envs{,_train,_test}` build a
  `vector.FusedBatchedEnvs` for a benchmark and, when any of the
  reference's wrapper-stack kwargs is given, put a `wrappers.EnvPipeline`
  around it. Other kwargs (`device`, `physics`, `task_select`,
  `autoreset`, ...) go to the engine; the device defaults to "cuda".
- `GymVectorBatch`: a `gymnasium.vector.VectorEnv` facade over an engine
  or pipeline, numpy in and out; `register_mw_envs` registers the
  reference's Gymnasium IDs.

Gymnasium is optional: without it `SawyerEnv` and `GymVectorBatch` are
plain classes and `register_mw_envs` does nothing.
"""

from __future__ import annotations

import functools
import io

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import env_reset, env_step, obs_bounds
from metaworld_tpu_torch.types import MAX_PATH_LENGTH, MAX_RAND, info_dict
from metaworld_tpu_torch.wrappers import EnvPipeline

try:
    import gymnasium as gym
    from gymnasium.spaces import Box

    _HAS_GYM = True
except ImportError:  # pragma: no cover - gymnasium is an optional dependency
    _HAS_GYM = False


class SawyerEnv(gym.Env if _HAS_GYM else object):
    """Single-env Gymnasium API over `env_step` at n = 1 (the compatibility
    shim for parity testing against the reference; training should use
    `vector` instead).

    Matches ref SawyerXYZEnv semantics: 4-dim action, 39-dim obs, set_task
    or a seed required before step, truncation at 500 steps. `device`
    defaults to "cuda"; the step runs `env_step`'s default physics (the
    kernel on a CUDA device, the plain lane engine on the CPU). A seeded
    env without `set_task` draws its goals from
    `np.random.default_rng(seed)`, the reference's `np_random(seed)`
    stream; the task's rejection loop at reset draws from a
    `torch.Generator` seeded alike (it only runs for goal vectors that fail
    their task's test, which those draws never are).
    """

    metadata = {"render_modes": ["rgb_array", "depth_array", "human"],
                "render_fps": 80}

    def __init__(self, env_name: str, seed: int | None = None,
                 render_mode: str | None = None,
                 camera_name: str | None = None,
                 width: int = 480, height: int = 480,
                 reward_function_version: str = "v2", device="cuda",
                 **_ignored):
        self.env_name = env_name
        self.task_name = env_name
        self.reward_function_version = reward_function_version
        self.spec_ = registry.get_spec(env_name, reward_function_version)
        self.render_mode = render_mode
        self.camera_name = camera_name or "topview"
        self.width = int(width)
        self.height = int(height)
        self.max_path_length = MAX_PATH_LENGTH
        self.device = torch.device(device)

        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed if seed is not None else 0)
        self._task_vec: np.ndarray | None = None
        self._goal_visible = 1.0
        self._state = None
        self._set_task_called = False
        self.seeded_rand_vec = seed is not None

        if _HAS_GYM:
            self.action_space = Box(-np.ones(4, np.float32),
                                    np.ones(4, np.float32))
            lo, hi = obs_bounds(self.spec_, True)
            self.observation_space = Box(lo.astype(np.float64),
                                         hi.astype(np.float64))

    # -- reference API ---------------------------------------------------
    def seed(self, seed: int):
        self._rng = np.random.default_rng(seed)
        self._gen.manual_seed(seed)
        self.seeded_rand_vec = True
        return [seed]

    def set_task(self, task: benchmarks.Task) -> None:
        assert task.env_name == self.env_name
        self._task_vec = np.asarray(task.rand_vec)
        self._goal_visible = 0.0 if task.partially_observable else 1.0
        self._set_task_called = True

    def reset(self, seed: int | None = None, options=None):
        if seed is not None:
            self.seed(seed)
        if self._task_vec is not None:
            vec = self._task_vec
        else:
            # the reference's np_random stream: two reset_model draws with
            # rejection, the second wins (ref sawyer_xyz_env.py:664-710)
            vec = benchmarks.draw_reset_vec(self.spec_, self.env_name, self._rng)
        padded = np.zeros((1, MAX_RAND), np.float32)
        padded[0, : vec.shape[0]] = vec
        self._state, obs = env_reset(
            self.spec_, torch.from_numpy(padded).to(self.device),
            self._goal_visible, self._gen)
        self.curr_path_length = 0
        return obs[0].cpu().numpy().astype(np.float64), {}

    def step(self, action):
        if not self._set_task_called and self._task_vec is None \
                and not self.seeded_rand_vec:
            raise RuntimeError("You must call env.set_task or seed the env "
                               "before stepping (ref sawyer_xyz_env.py:161-173)")
        assert self._state is not None, "call reset() first"
        if self.curr_path_length >= self.max_path_length:
            raise ValueError("You must reset the env manually once truncate==True")
        act = torch.as_tensor(np.asarray(action, np.float32).reshape(1, 4),
                              device=self.device)
        self._state, out = env_step(self.spec_, self._state, act)
        self.curr_path_length += 1
        info = info_dict(out)
        # one copy to the host per step
        host = torch.cat([out.obs[0], out.reward, out.truncated.to(torch.float32)]
                         + list(info.values())).cpu().numpy()
        obs = host[:39].astype(np.float64)
        return (obs, float(host[39]), False, bool(host[40] > 0),
                {k: float(v) for k, v in zip(info, host[41:])})

    # -- state get/set + pickling (ref SawyerMocapBase, sawyer_xyz_env.py:
    # 87-131: get_env_state/set_env_state/__getstate__/__setstate__) -------
    def get_env_state(self):
        """Snapshot of the full env state (the reference returns (qpos,
        qvel); here `torch.save` bytes of the whole EnvState), the path
        length and the reset generator's state (whose form depends on the
        device type: restore it into an env on the same kind of device)."""
        buf = io.BytesIO()
        torch.save(self._state.map(lambda t: t.detach().cpu()), buf)
        return buf.getvalue(), self.curr_path_length, self._gen.get_state()

    def set_env_state(self, snapshot) -> None:
        blob, path_length, gen_state = snapshot
        assert self._state is not None, "reset() once before set_env_state"
        # the bytes are get_env_state's: a pickled EnvState of tensors
        state = torch.load(io.BytesIO(blob), weights_only=False)
        self._state = state.map(lambda t: t.to(self.device))
        self.curr_path_length = path_length
        self._gen.set_state(gen_state)

    def __getstate__(self):
        state = None
        if self._state is not None:
            state = self.get_env_state()
        return {
            "env_name": self.env_name,
            "render_mode": self.render_mode,
            "camera_name": self.camera_name,
            "width": self.width,
            "height": self.height,
            "reward_function_version": self.reward_function_version,
            "device": str(self.device),
            "task_vec": self._task_vec,
            "goal_visible": self._goal_visible,
            "set_task_called": self._set_task_called,
            "seeded_rand_vec": self.seeded_rand_vec,
            "rng": self._rng,
            "gen": self._gen.get_state(),
            "env_state": state,
        }

    def __setstate__(self, d):
        self.__init__(d["env_name"], render_mode=d["render_mode"],
                      camera_name=d["camera_name"], width=d["width"],
                      height=d["height"],
                      reward_function_version=d["reward_function_version"],
                      device=d["device"])
        self._task_vec = d["task_vec"]
        self._goal_visible = d["goal_visible"]
        self._set_task_called = d["set_task_called"]
        self.seeded_rand_vec = d["seeded_rand_vec"]
        self._rng = d["rng"]
        self._gen.set_state(d["gen"])
        if d["env_state"] is not None:
            self.reset()
            self.set_env_state(d["env_state"])

    def render(self):
        """rgb_array / depth_array from the configured camera (ref cameras
        topview/corner/corner2/corner3/corner4/behindGripper/gripperPOV,
        xyz_base.xml:16-20,152-153; width/height per _init_each_env,
        ref __init__.py:407-410). "human" displays the frame and returns
        None (gymnasium semantics, ref docs/rendering/rendering.md): a
        matplotlib window when a GUI display exists, else frames are
        written under ./renders/<env>/ — the headless stand-in for the
        reference's GLFW viewer."""
        from metaworld_tpu_torch.render import render_camera

        depth = self.render_mode == "depth_array"
        cam = self.camera_name
        if depth and cam == "topview":
            cam = "corner"
        img = render_camera(self.spec_, self._state, camera=cam, depth=depth,
                            width=self.width, height=self.height)
        if self.render_mode != "human":
            return img
        self._human_frame_idx = getattr(self, "_human_frame_idx", -1) + 1
        try:
            import os
            if os.environ.get("DISPLAY"):
                import matplotlib.pyplot as plt
                if not hasattr(self, "_human_fig"):
                    plt.ion()
                    self._human_fig, ax = plt.subplots()
                    self._human_im = ax.imshow(img)
                    ax.set_axis_off()
                else:
                    self._human_im.set_data(img)
                self._human_fig.canvas.draw_idle()
                self._human_fig.canvas.flush_events()
                return None
        except Exception:  # no GUI backend — fall through to file frames
            pass
        import pathlib

        out = pathlib.Path("renders") / self.env_name
        out.mkdir(parents=True, exist_ok=True)
        try:
            from PIL import Image
            Image.fromarray(img).save(out / f"{self._human_frame_idx:06d}.png")
        except ImportError:
            np.save(out / f"{self._human_frame_idx:06d}.npy", img)
        return None


# ---------------------------------------------------------------------------
# goal-hidden / goal-observable factories (ref env_dict.py:130-212)
# ---------------------------------------------------------------------------


def make_goal_hidden(env_name: str, seed: int | None = None, **kw) -> SawyerEnv:
    """Env whose goal is hidden from the observation (ref
    _create_hidden_goal_envs). `kw` go to SawyerEnv (`device`, ...)."""
    env = SawyerEnv(env_name, seed=seed, **kw)
    env._goal_visible = 0.0
    return env


def make_goal_observable(env_name: str, seed: int | None = None,
                         **kw) -> SawyerEnv:
    """(ref _create_observable_goal_envs)"""
    env = SawyerEnv(env_name, seed=seed, **kw)
    env._goal_visible = 1.0
    return env


# ---------------------------------------------------------------------------
# vector factories (ref metaworld/__init__.py:460-604)
# ---------------------------------------------------------------------------

_PIPELINE_KWARGS = ("reward_normalization_method", "normalize_observations",
                    "recurrent_info_in_obs", "normalize_rnn_reward",
                    "reward_norm_gamma")


def _split_pipeline_kwargs(kwargs):
    return {k: kwargs.pop(k) for k in list(kwargs) if k in _PIPELINE_KWARGS}


def _maybe_pipeline(envs, pipe_kwargs):
    """Assemble the reference's wrapper stack around the engine when any of
    _init_each_env's normalization/augmentation kwargs are requested
    (ref metaworld/__init__.py:398-457)."""
    if not pipe_kwargs:
        return envs
    return EnvPipeline(envs, **pipe_kwargs)


def make_mt_envs(name: str, seed: int | None = None, num_goals: int = 50,
                 envs_per_task: int = 1, use_one_hot: bool = False,
                 terminate_on_success: bool = False,
                 max_episode_steps: int = MAX_PATH_LENGTH, **kwargs):
    """MT benchmark batch (ref make_mt_envs :460-513). `name` is an env name
    (-> MT1) or one of MT10/MT25/MT50; `seed` seeds the benchmark's goal
    tables. Accepts the reference's wrapper-stack kwargs
    (reward_normalization_method, normalize_observations,
    recurrent_info_in_obs) and returns an EnvPipeline when any are set."""
    if name in ("MT10", "MT25", "MT50"):
        bench = getattr(benchmarks, name)(seed=seed, num_goals=num_goals)
    else:
        bench = benchmarks.MT1(name, seed=seed, num_goals=num_goals)
    pk = _split_pipeline_kwargs(kwargs)
    envs = vector.from_benchmark(
        bench,
        envs_per_task=envs_per_task,
        one_hot=use_one_hot,
        terminate_on_success=terminate_on_success,
        max_episode_steps=max_episode_steps,
        **kwargs,
    )
    return _maybe_pipeline(envs, pk)


def make_ml_envs(name: str, seed: int | None = None,
                 meta_batch_size: int = 20, split: str = "train",
                 num_goals: int = 50, **kwargs):
    """ML benchmark batch (ref make_ml_envs :565-593): `meta_batch_size` env
    slots striped over the split's envs (ref task striping :540)."""
    if name in ("ML10", "ML25", "ML45"):
        bench = getattr(benchmarks, name)(seed=seed, num_goals=num_goals)
    else:
        bench = benchmarks.ML1(name, seed=seed, num_goals=num_goals)
    classes = bench.train_classes if split == "train" else bench.test_classes
    n_envs = len(classes)
    assert meta_batch_size % n_envs == 0, (
        "meta_batch_size must be divisible by the number of envs "
        "(ref __init__.py:518-524)"
    )
    pk = _split_pipeline_kwargs(kwargs)
    envs = vector.from_benchmark(
        bench, split=split, envs_per_task=meta_batch_size // n_envs, **kwargs
    )
    return _maybe_pipeline(envs, pk)


# the reference partials pin pseudorandom task selection for the meta
# protocol (ref __init__.py:594-603)
make_ml_envs_train = functools.partial(
    make_ml_envs, split="train", terminate_on_success=False,
    task_select="pseudorandom")
make_ml_envs_test = functools.partial(
    make_ml_envs, split="test", terminate_on_success=True,
    task_select="pseudorandom")


class GymVectorBatch(gym.vector.VectorEnv if _HAS_GYM else object):
    """gymnasium.vector.VectorEnv facade over a batched engine or pipeline:
    numpy in and out, the state held on the engine's device, in-graph
    NEXT_STEP autoreset. Lets the batch drop into code written for the
    reference's `gym.make_vec("Meta-World/MT10", ...)` (ref
    register_mw_envs __init__.py:630-779). `seed` seeds the first reset;
    `reset(seed=...)` reseeds the engine's generator."""

    def __init__(self, envs, seed=None):
        if _HAS_GYM:
            self.metadata = {"autoreset_mode": gym.vector.AutoresetMode.NEXT_STEP}
        self.envs = envs
        self.num_envs = envs.num_envs
        if _HAS_GYM:
            from gymnasium.vector.utils import batch_space

            self.single_action_space = Box(-np.ones(4, np.float32),
                                           np.ones(4, np.float32))
            d = envs.obs_dim
            self.single_observation_space = Box(
                np.full(d, -np.inf, np.float64), np.full(d, np.inf, np.float64))
            self.action_space = batch_space(self.single_action_space,
                                            self.num_envs)
            self.observation_space = batch_space(self.single_observation_space,
                                                 self.num_envs)
        self._seed = seed
        self._state = None

    def _engine(self):
        e = self.envs
        while not hasattr(e, "task_select") and hasattr(e, "envs"):
            e = e.envs
        return e

    def reset(self, *, seed=None, options=None):
        if seed is None:
            seed, self._seed = self._seed, None
        # pseudorandom task select resets onto the pinned goals (the
        # reference's sample_tasks_on_reset=False semantics); unseeded
        # resets draw on from the engine's generator
        if self._engine().task_select == "pseudorandom" and self._state is not None:
            self._state, obs = self.envs.reset(seed=seed, vstate=self._state)
        else:
            self._state, obs = self.envs.reset(seed=seed)
        return obs.cpu().numpy(), {}

    def step(self, actions):
        assert self._state is not None, "call reset() first"
        dev = self._engine().device
        act = torch.as_tensor(np.asarray(actions, np.float32), device=dev)
        self._state, out = self.envs.step(self._state, act)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        infos = {k: v for k, v in host.items()
                 if k not in ("obs", "reward", "terminated", "truncated")}
        # the reference's eval loops read final_info at done steps
        # (ref metaworld/evaluation.py:78-82); the engine's episode_return
        # at the done step already holds the full episode total
        infos["final_info"] = {
            "episode": {"r": infos["episode_return"],
                        "l": infos["episode_length"]},
            "success": infos["success"],
        }
        return (host["obs"], host["reward"], host["terminated"],
                host["truncated"], infos)

    def get_attr(self, name):
        if name == "task_name":
            return self._engine().env_task_names()
        if name == "terminate_on_success":
            return [self._engine().terminate_on_success] * self.num_envs
        return getattr(self.envs, name)

    def call(self, method, *args):
        """`.call` support for the reference's evaluation protocols
        (toggle_terminate_on_success ref evaluation.py:54,96; sample_tasks
        + toggle_sample_tasks_on_reset ref evaluation.py:114-125)."""
        engine = self._engine()
        if method == "sample_tasks":
            assert engine.task_select == "pseudorandom", (
                "sample_tasks needs task_select='pseudorandom' envs "
                "(ref PseudoRandomTaskSelectWrapper)")
            assert self._state is not None, "call reset() first"
            self._state = engine.sample_tasks(self._state)
            return [None] * self.num_envs
        if method == "toggle_sample_tasks_on_reset":
            # pinned (pseudorandom) mode never resamples on reset; random
            # mode always does: the flag is the mode itself, so this is a
            # consistency assertion rather than a mutation
            want = bool(args[0])
            have = engine.task_select == "random"
            assert want == have or not want, (
                "toggle_sample_tasks_on_reset(True) requires "
                "task_select='random' envs")
            return [None] * self.num_envs
        if method == "toggle_terminate_on_success":
            # the step reads the flag on every call
            engine.terminate_on_success = bool(args[0])
            return [None] * self.num_envs
        raise AttributeError(method)

    def close(self, **kwargs):
        pass


def register_mw_envs() -> None:
    """Registers the reference's Gymnasium IDs (ref register_mw_envs
    :607-823): Meta-World/MT1, Meta-World/goal_hidden and
    Meta-World/goal_observable for single envs through gym.make; the MT/ML
    batches, custom-mt-envs and custom-ml-envs as vector entry points
    (gym.make_vec) that return a GymVectorBatch over the fused engine.
    Keyword arguments reach the env or the factory (`device=`, ...).
    IDs that another package registered (the JAX package registers the
    same ones) are replaced, so the IDs always resolve to this package."""
    if not _HAS_GYM:
        return
    from gymnasium.envs.registration import register, registry as gym_registry

    mt1 = gym_registry.get("Meta-World/MT1")
    if mt1 is not None and getattr(mt1.entry_point, "__module__", None) == __name__:
        return
    for key in [k for k in gym_registry if k.startswith("Meta-World/")]:
        del gym_registry[key]
    register(id="Meta-World/MT1",
             entry_point=lambda env_name, seed=None, **kw: SawyerEnv(
                 env_name, seed=seed, **kw))
    register(id="Meta-World/goal_hidden",
             entry_point=lambda env_name, seed=None, **kw: make_goal_hidden(
                 env_name, seed, **kw))
    register(id="Meta-World/goal_observable",
             entry_point=lambda env_name, seed=None, **kw: make_goal_observable(
                 env_name, seed, **kw))

    def _vec(factory):
        def entry(*args, num_envs=None, **kw):
            seed = kw.pop("seed", None)
            return GymVectorBatch(factory(*args, seed=seed, **kw), seed=seed)
        return entry

    for mt in ("MT10", "MT25", "MT50"):
        register(id=f"Meta-World/{mt}", vector_entry_point=(lambda _mt: _vec(
            lambda seed=None, **kw: make_mt_envs(_mt, seed=seed, **kw)))(mt))
    register(id="Meta-World/ML1-train",
             vector_entry_point=_vec(lambda env_name, seed=None, **kw:
                                     make_ml_envs_train(env_name, seed=seed, **kw)))
    register(id="Meta-World/ML1-test",
             vector_entry_point=_vec(lambda env_name, seed=None, **kw:
                                     make_ml_envs_test(env_name, seed=seed, **kw)))
    for ml in ("ML10", "ML25", "ML45"):
        for split, fn in (("train", make_ml_envs_train),
                          ("test", make_ml_envs_test)):
            register(id=f"Meta-World/{ml}-{split}",
                     vector_entry_point=(lambda _ml, _fn: _vec(
                         lambda seed=None, **kw: _fn(_ml, seed=seed, **kw)))(ml, fn))
    register(id="Meta-World/custom-mt-envs",
             vector_entry_point=_vec(lambda envs_list, seed=None, **kw:
                                     _custom_mt(envs_list, seed, **kw)))
    register(id="Meta-World/custom-ml-envs",
             vector_entry_point=_vec(
                 lambda train_envs, test_envs, seed=None, split="train", **kw:
                 _custom_ml(train_envs, test_envs, seed, split, **kw)))


def _custom_mt(envs_list, seed=None, **kw):
    """(ref custom-mt-envs registration :780-800)"""
    bench = benchmarks._mt(list(envs_list), seed)
    pk = _split_pipeline_kwargs(kw)
    return _maybe_pipeline(vector.from_benchmark(bench, **kw), pk)


def _custom_ml(train_envs, test_envs, seed=None, split="train", **kw):
    """(ref custom-ml-envs registration :801-823)"""
    bench = benchmarks.CustomML(list(train_envs), list(test_envs), seed)
    pk = _split_pipeline_kwargs(kw)
    return _maybe_pipeline(vector.from_benchmark(bench, split=split, **kw), pk)

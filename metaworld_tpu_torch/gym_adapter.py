"""Public env factories (counterpart of the vector factories of
`metaworld_tpu/gym_adapter.py:263-346`, ref metaworld/__init__.py:460-604).

`make_mt_envs` and `make_ml_envs{,_train,_test}` build a
`vector.FusedBatchedEnvs` for a benchmark and, when any of the reference's
wrapper-stack kwargs is given, put a `wrappers.EnvPipeline` around it.
Other kwargs (`device`, `physics`, `task_select`, `autoreset`, ...) go to
the engine; the device defaults to "cuda".

Still to come from the JAX module: the single-env Gymnasium `SawyerEnv`,
`make_goal_hidden` / `make_goal_observable`, `GymVectorBatch`,
`register_mw_envs` and its custom entries. Until `SawyerEnv` lands this
module does not import gymnasium.
"""

from __future__ import annotations

import functools

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.types import MAX_PATH_LENGTH
from metaworld_tpu_torch.wrappers import EnvPipeline

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

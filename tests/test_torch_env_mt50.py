"""Per task of MT50 beyond MT25 and its helper tasks (the 22 last task
modules of the port): the port's scene rows, reset and step tail against
the JAX package, the reset's independence of its random generator on every
goal-table row, and MT50's goal tables bit for bit.

The checks and tolerances are those of test_torch_env.py: observations
1e-5 absolute (resets 1e-6); rewards and metrics 1e-5 relative or 1e-6
absolute; 0/1 flags exact; scene rows and goal tables bit-equal. Box-close,
door-close, hammer and the handle family have observation functions of
their own, which the step tail's observations hold.
"""

import dataclasses
import functools

import numpy as np
import pytest

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs import registry as jregistry
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch.envs import registry as tregistry
from metaworld_tpu_torch.types import SceneParams
from tests.test_torch_env import (
    N_GOALS, check_post_step, check_reset, check_reset_ignores_generator)
from tests.test_torch_env_mt25 import NEW as MT25_NEW

NEW = [n for n in jbench.MT50_LIST
       if n not in jbench.MT10_LIST and n not in MT25_NEW]


@functools.lru_cache(maxsize=None)
def _benches(seed=0):
    return (jbench.MT50(seed=seed, num_goals=N_GOALS),
            tbench.MT50(seed=seed, num_goals=N_GOALS))


def test_registry_serves_all_50_tasks():
    assert len(NEW) == 22
    assert tbench.MT50_LIST == jbench.MT50_LIST == tregistry.ALL_V3_ENVIRONMENTS
    for name in tregistry.ALL_V3_ENVIRONMENTS:
        spec = tregistry.get_spec(name)
        assert spec.name == name and spec.task_id == jregistry.TASK_ID[name]


@pytest.mark.parametrize("name", NEW)
def test_scene_rows_bit_equal(name):
    a = tregistry.get_spec(name).scene
    b = jregistry.get_spec(name).scene
    for f in dataclasses.fields(SceneParams):
        x, y = getattr(a, f.name), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, (name, f.name)
        np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("seed", [0, 42])
def test_mt50_goal_tables_bit_equal(seed):
    a, b = tbench.MT50(seed=seed), jbench.MT50(seed=seed)
    assert list(a.train_classes) == list(b.train_classes) == jbench.MT50_LIST
    for name in jbench.MT50_LIST:
        x, y = a.goal_table(name), b.goal_table(name)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name", NEW)
def test_env_reset_matches_jax(name):
    check_reset(name, *_benches())


@pytest.mark.parametrize("name", NEW)
def test_post_step_matches_jax(name):
    check_post_step(name, *_benches())


@pytest.mark.parametrize("name", NEW)
def test_reset_ignores_generator_on_goal_rows(name):
    _, tb = _benches(seed=42)
    check_reset_ignores_generator(tb.train_classes[name], tb.goal_table(name))

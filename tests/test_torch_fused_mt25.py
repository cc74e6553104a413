"""MT25 as a whole: the port's FusedBatchedEnvs (plain PyTorch physics)
against the JAX package's FusedBatchedEnvs(physics="lanes") on the 25 MT25
tasks with 2 slots each, one-hot ids, pinned goal rows and
max_episode_steps=4, so every slot crosses NEXT_STEP autoreset at least
twice. The checks and tolerances are test_torch_fused.py's.

Stick-pull's reset leaves its container coasting (a reset override of
obj_vel); the reset table carries it, and autoreset restores it.
"""

import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from tests.test_torch_env import _assert_tree_close
from tests.test_torch_fused import check_fused, make_engines

MT25 = jbench.MT25_LIST


@pytest.fixture(scope="module")
def engines():
    jb, tb = jbench.MT25(seed=0, num_goals=5), tbench.MT25(seed=0, num_goals=5)
    return make_engines(jb, tb, MT25, 2)


def test_fused_step_matches_jax(engines):
    je, te, step_j = engines
    assert te.obs_dim == 39 + 25
    states = check_fused(je, te, step_j, n_goals=5, steps=12)
    # the thermos kick survives autoreset: each stick-pull slot's container
    # velocity is back at the reset value on the step after its reset
    k = MT25.index("stick-pull-v3")
    a, b = int(te._offsets[k]), int(te._offsets[k + 1])
    kicked = [s.env.sim.obj_vel[a:b, 1, 0] for s in states
              if bool((s.env.path_length[a:b] == 0).all())]
    assert kicked
    for v in kicked:
        np.testing.assert_array_equal(v.numpy(), np.float32(0.6793))


def test_reset_table_is_a_function_of_the_goal_row(engines):
    """Two engines built with differently seeded generators hold the same
    reset table: every MT25 reset is a pure function of its goal row."""
    _, te, _ = engines
    tb = tbench.MT25(seed=0, num_goals=5)
    other = type(te)([tb.train_classes[n] for n in MT25], [2] * 25,
                     [tb.goal_table(n) for n in MT25], device="cpu", seed=7,
                     one_hot=True, max_episode_steps=4,
                     task_select="pseudorandom")
    assert torch.equal(other._reset_obs, te._reset_obs)
    _assert_tree_close(convert.as_dict(other._reset_env),
                       convert.as_dict(te._reset_env), 0.0)

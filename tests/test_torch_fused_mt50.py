"""MT50 as a whole: the port's FusedBatchedEnvs (plain PyTorch physics)
against the JAX package's FusedBatchedEnvs(physics="lanes") on all 50
tasks with one slot each, one-hot ids, pinned goal rows and
max_episode_steps=4, so every slot crosses NEXT_STEP autoreset at least
twice. The checks and tolerances are test_torch_fused.py's; the steps are
cut to 10 (the JAX jit of fifty task tails is the cost), not the tasks.

Every step restarts the port from the JAX state. A free run drifts: the
jitted JAX physics fuses multiply-adds that PyTorch rounds twice, the two
states part by a few 1e-7 m per step, and over four free steps the
knife-edge button press of button-press-topdown turns that into a return
3e-5 apart, past the 1e-5 reward tolerance. Restarting holds each step's
outputs, and the state comparison after every step holds the port's own
done, pending-reset, return and length bookkeeping through both
autoresets.
"""

import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from tests.test_torch_env import _assert_tree_close
from tests.test_torch_fused import check_fused, make_engines

MT50 = jbench.MT50_LIST


@pytest.fixture(scope="module")
def engines():
    jb, tb = jbench.MT50(seed=0, num_goals=5), tbench.MT50(seed=0, num_goals=5)
    return make_engines(jb, tb, MT50, 1)


def test_fused_step_matches_jax(engines):
    je, te, step_j = engines
    assert te.obs_dim == 39 + 50
    check_fused(je, te, step_j, n_goals=5, steps=10, restart=10)


def test_reset_table_is_a_function_of_the_goal_row(engines):
    """Two engines built with differently seeded generators hold the same
    reset table: every MT50 reset is a pure function of its goal row."""
    _, te, _ = engines
    tb = tbench.MT50(seed=0, num_goals=5)
    other = type(te)([tb.train_classes[n] for n in MT50], [1] * 50,
                     [tb.goal_table(n) for n in MT50], device="cpu", seed=7,
                     one_hot=True, max_episode_steps=4,
                     task_select="pseudorandom")
    assert torch.equal(other._reset_obs, te._reset_obs)
    _assert_tree_close(convert.as_dict(other._reset_env),
                       convert.as_dict(te._reset_env), 0.0)

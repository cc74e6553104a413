"""The closed loop on the CPU: each of the five spot tasks of
test_behavioral_bar.py, its expert driving the port's fused engine (10
slots on goal rows 0-9 of `MT1(name, seed=42)`, physics="torch",
task_select="pseudorandom", autoreset=False)
for 500 steps; a slot succeeds if any step succeeded, and the task must
reach the reference's bar of 0.80. About 90 s per task on a CPU,
so marked `slow` and left out of the default run; the full-width loop
(all 50 tasks x 50 goal rows, N = 131072) runs on the card in
chip_smoke.py's phase 13. Run with `python -m pytest
tests/test_torch_policies_loop.py -m slow`.

A second slow test holds the port's loop row by row against the JAX
package's lane engine on door-unlock-v3, whose success over the 50 goal
rows of MT50(seed=42) sits exactly on the bar (0.80 on both JAX engines,
`scripts/policy_goal_rows.py`): the same rows must fail (about 3.5 min).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu_torch import benchmarks, evaluation, vector

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))

SPOT = ["reach-v3", "pick-place-v3", "door-open-v3", "hammer-v3", "stick-pull-v3"]
N_GOALS = 10
STEPS = 500


def _closed_loop(bench, name, n_goals):
    """Each slot's max success over STEPS steps of `name`'s expert, slot j
    on goal row j of the benchmark's goal table."""
    envs = vector.FusedBatchedEnvs(
        [bench.train_classes[name]], [n_goals], [bench.goal_table(name)],
        physics="torch", device="cpu", task_select="pseudorandom",
        autoreset=False)
    agent = evaluation.ScriptedAgent(envs)
    state, obs = envs.reset(torch.arange(n_goals, dtype=torch.int32))
    success = torch.zeros(n_goals)
    with torch.no_grad():
        for _ in range(STEPS):
            state, out = envs.step(state, agent.eval_action(obs))
            obs = out["obs"]
            success = torch.maximum(success, out["success"])
    assert bool(torch.isfinite(obs).all())
    return success


@pytest.mark.slow
@pytest.mark.parametrize("name", SPOT)
def test_closed_loop_bar(name):
    rate = float(_closed_loop(benchmarks.MT1(name, seed=42), name, N_GOALS).mean())
    assert rate >= 0.8, f"{name}: {rate:.2f} < 0.80 over {N_GOALS} goal rows"


@pytest.mark.slow
def test_goal_rows_match_the_jax_lane_engine():
    from policy_goal_rows import lanes

    name = "door-unlock-v3"
    jb = jbench.MT50(seed=42)
    ref = lanes(jb.train_classes[name], name, jb.goal_table(name))
    ours = _closed_loop(benchmarks.MT50(seed=42), name, 50).numpy()
    np.testing.assert_array_equal(ours > 0, ref > 0)
    assert float((ours > 0).mean()) >= 0.8

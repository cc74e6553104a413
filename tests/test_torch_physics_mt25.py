"""The port's lane physics (the CUDA kernel's plain version) against the
JAX package's `engine_lanes.control_step` on one batch that holds the
eighteen scenes MT25 adds to MT10 and its helper tasks (assembly,
stick-push, button-press): holes and pits (sweep-into), planar slide
bodies and the tool link (the stick tasks), hooks that only carry
(lever-pull), hinged fixtures with hooks (faucets, dial, lever) and the
mug's grasp tolerance (coffee-pull).

Random and seek modes, 25 steps each, with the tolerances and the eager
rerun rule of test_torch_physics.py.
"""

import numpy as np
import pytest
import torch

from metaworld_tpu_torch.physics import engine_lanes as tlanes
from tests.test_torch_env_mt25 import NEW
from tests.test_torch_physics import check_control_step, reset_batch


@pytest.mark.parametrize("mode", ["random", "seek"])
def test_control_step_matches_jax(mode):
    check_control_step(mode, *reset_batch(near=mode == "seek", names=NEW))


def test_number_over_tensor_rounds_once():
    """The plain physics divides a Python number by a tensor with one
    rounding, as XLA and the CUDA kernel do. PyTorch's own `c / t` is
    `t.reciprocal() * c`, two roundings; on the hand speed cap, the lever
    joint's velocity cap and the bar collar that parted the plain version
    from the kernel by a few ulps wherever those caps bound (the seek mode
    of chip_smoke.py's MT25 phase)."""
    t = torch.from_numpy(np.random.default_rng(0).uniform(0.05, 3.0, 4096)
                         .astype(np.float32))
    # float32(1.2) / t, correctly rounded (float64 holds the exact quotient
    # closely enough that rounding it to float32 rounds once)
    t64 = t.double()
    exact = (torch.full_like(t64, float(np.float32(1.2))) / t64).float()
    assert torch.equal(tlanes._x.div(1.2, t), exact)
    assert not torch.equal(1.2 / t, exact)  # the two-rounding form

"""The kernel's host build (see test_torch_kernel_host.py) against the
port's plain version on the 22 scenes MT50 adds: the anchored plug's hook
grasp, the door panel without a hook, slide-limited pucks, the 10 cm pit,
pulled handles and the hammer with its nail; and the kernel's per-block
code over all of MT50's block dispatch.

The seek mode steers to test_torch_physics_mt50.seek_targets' targets,
the grasp points among them, so the plug unanchors and the hammer
attaches. The four variants of one mode are held on one plain trajectory
(25 control steps of the 66-env batch), made once per mode.
"""

import functools

import pytest
import torch

from metaworld_tpu_torch import benchmarks as tbench
from tests.test_torch_kernel_host import (  # noqa: F401  (host_lib: fixture)
    MT10, MT25_NEW, _batch, check_block_dispatch, hold_steps, host_lib,
    plain_steps, variant_runner)

MT50_NEW = [n for n in tbench.MT50_LIST if n not in MT10 and n not in MT25_NEW]
SEED = {"random": 6, "seek": 7}


@functools.lru_cache(maxsize=None)
def _trajectory(mode):
    """The batch of the 22 scenes and its plain trajectory in `mode`."""
    table, ids, env = _batch(near=mode == "seek", names=MT50_NEW,
                             grasp_targets=True)
    return table, ids, plain_steps(table, ids, env, mode, SEED[mode])


@pytest.mark.parametrize("mode", ["random", "seek"])
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_host_kernel_matches_plain_mt50_scenes(host_lib, variant, mode):
    table, ids, steps = _trajectory(mode)
    run, mask = variant_runner(host_lib, variant, table, ids)
    hold_steps(run, table, ids, steps, mask, f"v{variant} {mode}")


def test_seek_trajectory_reaches_the_new_branches():
    """The seek trajectory the variants are held on unanchors the plug and
    attaches the hammer."""
    table, ids, steps = _trajectory("seek")
    for name, field in (("peg-unplug-side-v3", "unanchored"),
                        ("hammer-v3", "attached")):
        slots = ids == MT50_NEW.index(name)
        seen = torch.stack([getattr(ref, field)[slots] != 0 for _, _, ref in steps])
        assert bool(seen.any()), f"no {name} slot {field}"


@pytest.mark.parametrize("mode", ["random", "seek"])
def test_host_block_dispatch_matches_plain_mt50(host_lib, mode):
    check_block_dispatch(host_lib, tbench.MT50_LIST, 6, mode, 6,
                         grasp_targets=True)

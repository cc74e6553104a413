"""The seek mode of test_torch_physics_mt50.py on the first eleven of the
22 new scenes (the other eleven are in test_torch_physics_mt50_seek_b.py;
files of their own, so that `--dist loadfile` runs them beside the random
mode): every slot starts 3 cm above its target (the object's reset anchor,
its reported position or its grasp point, in turn), steers to it and
closes the grip there, for 25 steps against the jitted JAX step with the
eager rerun rule of test_torch_physics.py. The hammer must attach and both
pulled handles hook; in the other half the plug must come unanchored.
"""

from tests.test_torch_physics import check_control_step
from tests.test_torch_physics_mt50 import NEW, _seen, seek_batch

HALF = NEW[:11]


def check_seek(names, must_see):
    sims = check_control_step("seek", *seek_batch(names))
    for field, name in must_see:
        assert _seen(sims, field, name, names) > 0, (field, name)


def test_control_step_matches_jax_seek():
    check_seek(HALF, [("attached", "hammer-v3"),
                      ("hooked", "handle-pull-v3"),
                      ("hooked", "handle-pull-side-v3")])

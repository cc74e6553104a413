"""The seek mode of test_torch_physics_mt50.py on the last eleven of the 22
new scenes (see test_torch_physics_mt50_seek.py): the plate-slide pucks,
the anchored plug, soccer, the walls, the shelf and sweep. The plug must
come unanchored.
"""

from tests.test_torch_physics_mt50 import NEW
from tests.test_torch_physics_mt50_seek import check_seek

HALF = NEW[11:]


def test_control_step_matches_jax_seek_b():
    check_seek(HALF, [("unanchored", "peg-unplug-side-v3")])

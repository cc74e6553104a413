"""The port's MJCF compiler (`metaworld_tpu_torch.envs.mjcf`) against the
JAX package's on inline scenes: an <include>, euler and quaternion frames,
box, cylinder, capsule, sphere and mesh geoms, collision classes from
<default>, and free, slide and hinge joints. Every field of every parsed
body, geom and joint must be equal, and so must the compiled static boxes.
The cross-check against the reference's assets stays with
tests/test_mjcf_compiler.py, which skips where they are not mounted."""

import dataclasses

import numpy as np
import pytest

from metaworld_tpu.envs import mjcf as jmjcf
from metaworld_tpu_torch.envs import mjcf

INCLUDED = """
<mujocoinclude>
  <body name="drawer" pos="0 0.7 0.1" euler="0 0 1.5707963">
    <geom type="box" size="0.1 0.05 0.02" pos="0.01 0 0" class="col"/>
    <geom type="box" size="0.1 0.05 0.02" class="viz"/>
    <body name="drawer_link" pos="0 -0.05 0">
      <joint type="slide" axis="0 1 0" range="-0.16 0" damping="2"
             pos="0 0 0.01"/>
      <geom type="capsule" size="0.01 0.04" quat="0.7071068 0.7071068 0 0"/>
    </body>
  </body>
</mujocoinclude>
"""

SCENE = """
<mujoco>
  <default>
    <default class="col"><geom contype="1" conaffinity="1"/></default>
    <default class="viz"><geom contype="0" conaffinity="0"/></default>
  </default>
  <worldbody>
    <include file="drawer.xml"/>
    <body name="box" pos="0.1 0.8 0" quat="0.9238795 0 0 0.3826834">
      <geom type="box" size="0.02 0.03 0.04" pos="0.02 0 0.05"/>
      <geom type="cylinder" size="0.015 0.03" euler="1.5707963 0 0"/>
      <geom mesh="handle_mesh" pos="0 0 0.1"/>
      <body name="box_lid" pos="0 0 0.1">
        <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
      </body>
      <body name="door" pos="0 0.1 0">
        <joint name="hinge" axis="0 0 1" range="0 1.57" stiffness="0.5"
               springref="0.2"/>
        <geom type="box" size="0.1 0.01 0.1" pos="0 0 0.1"/>
      </body>
    </body>
    <body name="puck" pos="0 0.6 0.02">
      <freejoint/>
      <geom type="cylinder" size="0.02 0.015"/>
      <geom type="sphere" size="0.01" pos="0 0 0.02"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("mjcf")
    (d / "drawer.xml").write_text(INCLUDED)
    (d / "scene.xml").write_text(SCENE)
    return d / "scene.xml"


def _same(a, b, where):
    assert type(a).__name__ == type(b).__name__, where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{f.name}")
            assert x.dtype == y.dtype, f"{where}.{f.name}"
        else:
            assert x == y, f"{where}.{f.name}"


def test_parsed_model_equals_the_jax_parser(scene):
    got, ref = mjcf.parse_mjcf(scene), jmjcf.parse_mjcf(scene)
    for kind in ("bodies", "geoms", "joints"):
        g, r = getattr(got, kind), getattr(ref, kind)
        assert len(g) == len(r), kind
        for i, (a, b) in enumerate(zip(g, r)):
            _same(a, b, f"{kind}[{i}]")
    # the scene exercises every branch the comparison is meant to cover
    assert {g.kind for g in got.geoms} == {"box", "cylinder", "capsule", "sphere"}
    assert {j.kind for j in got.joints} == {"free", "slide", "hinge"}
    assert {g.is_collision for g in got.geoms} == {True, False}
    assert "drawer_link" in {b.name for b in got.bodies}


@pytest.mark.parametrize("root", ["box", "drawer", "puck"])
def test_static_boxes_and_body_geoms_equal_the_jax_parser(scene, root):
    got, ref = mjcf.parse_mjcf(scene), jmjcf.parse_mjcf(scene)
    gb, rb = got.static_boxes(root), ref.static_boxes(root)
    assert len(gb) == len(rb)
    for (p, h), (q, k) in zip(gb, rb):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(h, k)
    for collision_only in (True, False):
        g = got.body_geoms(root, collision_only)
        r = ref.body_geoms(root, collision_only)
        assert len(g) == len(r)
        for i, (a, b) in enumerate(zip(g, r)):
            _same(a, b, f"{root} geom {i}")

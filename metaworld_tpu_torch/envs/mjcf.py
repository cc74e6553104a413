"""MJCF scene compiler: MuJoCo XML -> SceneParams building blocks.

The port's copy of `metaworld_tpu/envs/mjcf.py` (numpy only; nothing at run
time uses it in either package). The reference compiles 38 MJCF scene
files (plus includes) through MuJoCo's native model compiler at env
construction (ref sawyer_xyz_env.py:221-229 -> gymnasium MujocoEnv; assets
under metaworld/assets/). This module parses a scene XML (resolving
<include> recursively), walks the body tree accumulating poses, and
compiles

  * static-body collision geoms  -> axis-aligned StaticBox rows
    (boxes/cylinders/capsules/spheres; orientations snapped to the nearest
    axis permutation — every fixture in the 38 scenes is axis-aligned or
    rotated by a multiple of 90 degrees),
  * free-joint bodies            -> FreeObj rows (contact radius / resting
    half-height from the body's collision geom extents),
  * 1-dof slide/hinge joints     -> FixtureJoint rows (axis, range,
    damping, stiffness, springref in the body's world frame).

The curated scenes in envs/tasks/*.py remain the source of truth for the
shipped tasks (they also carry engine-calibrated interaction constants the
XML does not express: grasp widths, droop angles, handle radii).
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class GeomSpec:
    kind: str                 # box | cylinder | sphere | capsule | mesh | plane
    pos: np.ndarray           # world position (3,)
    half: np.ndarray          # world axis-aligned half extents (3,)
    body: str                 # owning body name
    is_collision: bool        # participates in contacts (contype/conaffinity)


@dataclasses.dataclass
class JointSpec:
    kind: str                 # free | slide | hinge
    body: str
    pos: np.ndarray           # world anchor (3,)
    axis: np.ndarray          # world axis (3,)
    range: tuple
    damping: float
    stiffness: float
    springref: float


@dataclasses.dataclass
class BodySpec:
    name: str
    pos: np.ndarray           # world position of the body frame


@dataclasses.dataclass
class MJCFModel:
    bodies: list
    geoms: list
    joints: list

    def body_geoms(self, body: str, collision_only: bool = True):
        return [g for g in self.geoms
                if g.body == body and (g.is_collision or not collision_only)]

    def static_boxes(self, root_body: str):
        """Collision AABBs of `root_body` and its non-jointed descendants,
        relative to the root body's frame (the engine's rel_fixture
        convention)."""
        root = next(b for b in self.bodies if b.name == root_body)
        jointed = {j.body for j in self.joints}
        out = []
        for g in self.geoms:
            if not g.is_collision or g.kind == "plane":
                continue
            if not (g.body == root_body or
                    (g.body.startswith(root_body) and g.body not in jointed)):
                continue
            out.append((g.pos - root.pos, g.half))
        return out


def _floats(s, n=None, default=None):
    if s is None:
        return default
    v = np.array([float(x) for x in s.split()])
    return v if n is None else v[:n]


def _rot_matrix(euler=None, quat=None):
    """Rotation matrix from MJCF euler (XYZ, radians — the metaworld assets
    set no compiler angle attribute, hence MuJoCo's radian default) or wxyz
    quat."""
    if quat is not None:
        w, x, y, z = quat
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
    if euler is None:
        return np.eye(3)
    cx, cy, cz = np.cos(euler)
    sx, sy, sz = np.sin(euler)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _snap_axis_rot(R):
    """Snap a rotation matrix to the nearest signed axis permutation (all
    metaworld fixtures are mounted at multiples of 90 degrees)."""
    S = np.zeros((3, 3))
    for i in range(3):
        j = int(np.argmax(np.abs(R[i])))
        S[i, j] = math.copysign(1.0, R[i, j])
    return S


def _geom_half_extents(kind, size, R):
    """World axis-aligned half extents of a geom under (snapped) rotation."""
    if kind == "sphere":
        r = size[0]
        local = np.array([r, r, r])
    elif kind in ("cylinder", "capsule"):
        r, h = size[0], size[1] if len(size) > 1 else size[0]
        if kind == "capsule":
            h = h + r
        local = np.array([r, r, h])
    elif kind == "box":
        local = np.array([size[0], size[1], size[2] if len(size) > 2 else size[1]])
    else:  # mesh / unknown: no analytic extent
        return None
    return np.abs(R @ np.diag(local)).max(axis=1)


def parse_mjcf(path: str | pathlib.Path) -> MJCFModel:
    """Parse an MJCF scene file, resolving <include> recursively."""
    path = pathlib.Path(path)

    def load(p: pathlib.Path) -> ET.Element:
        root = ET.parse(p).getroot()

        def resolve(elem: ET.Element, base: pathlib.Path):
            for i, child in enumerate(list(elem)):
                if child.tag == "include":
                    inc_path = (base / child.attrib["file"]).resolve()
                    inc_root = load(inc_path)
                    elem.remove(child)
                    for sub in reversed(list(inc_root)):
                        elem.insert(i, sub)
                else:
                    resolve(child, base)
        resolve(root, p.parent)
        return root

    root = load(path)

    # default classes: geom contype/conaffinity per class (collision classes
    # in the assets set conaffinity/contype; visual classes zero them)
    class_collide: dict[str, bool] = {}

    def walk_defaults(elem, current=None):
        if elem.tag == "default":
            current = elem.attrib.get("class", current)
            g = elem.find("geom")
            if g is not None and current is not None:
                con = int(g.attrib.get("contype", "1")) or \
                    int(g.attrib.get("conaffinity", "1"))
                class_collide[current] = bool(con)
        for child in elem:
            walk_defaults(child, current)

    for d in root.iter("default"):
        walk_defaults(d)

    bodies, geoms, joints = [], [], []

    def geom_collides(g, childclass):
        if "contype" in g.attrib or "conaffinity" in g.attrib:
            return bool(int(g.attrib.get("contype", "1")) or
                        int(g.attrib.get("conaffinity", "1")))
        cls = g.attrib.get("class", childclass)
        if cls is not None and cls in class_collide:
            return class_collide[cls]
        # visual-material geoms without a class default to collidable in
        # MuJoCo, but the assets mark all contact geoms via *_col classes;
        # a mesh without a collision class is display-only in practice
        return g.attrib.get("mesh") is None

    def walk(elem, pos, R, name_prefix, childclass):
        for child in elem:
            if child.tag == "body":
                bpos = pos + R @ _floats(child.attrib.get("pos"), 3,
                                         np.zeros(3))
                bR = R @ _rot_matrix(
                    _floats(child.attrib.get("euler"), 3),
                    _floats(child.attrib.get("quat"), 4),
                )
                bname = child.attrib.get("name",
                                         f"{name_prefix}#{len(bodies)}")
                bodies.append(BodySpec(name=bname, pos=bpos.copy()))
                cc = child.attrib.get("childclass", childclass)
                walk(child, bpos, bR, bname, cc)
            elif child.tag == "geom":
                kind = child.attrib.get("type",
                                        "mesh" if "mesh" in child.attrib
                                        else "sphere")
                gpos = pos + R @ _floats(child.attrib.get("pos"), 3,
                                         np.zeros(3))
                gR = _snap_axis_rot(R @ _rot_matrix(
                    _floats(child.attrib.get("euler"), 3),
                    _floats(child.attrib.get("quat"), 4)))
                size = _floats(child.attrib.get("size"), default=np.array([0.01]))
                half = _geom_half_extents(kind, size, gR)
                if half is None:
                    continue
                geoms.append(GeomSpec(
                    kind=kind, pos=gpos.copy(), half=half,
                    body=name_prefix,
                    is_collision=geom_collides(child, childclass),
                ))
            elif child.tag == "freejoint":
                joints.append(JointSpec(
                    kind="free", body=name_prefix, pos=pos.copy(),
                    axis=np.array([0.0, 0.0, 1.0]), range=(0.0, 0.0),
                    damping=0.0, stiffness=0.0, springref=0.0))
            elif child.tag == "joint":
                kind = child.attrib.get("type", "hinge")
                jpos = pos + R @ _floats(child.attrib.get("pos"), 3,
                                         np.zeros(3))
                axis = R @ _floats(child.attrib.get("axis"), 3,
                                   np.array([0.0, 0.0, 1.0]))
                rng = _floats(child.attrib.get("range"), 2)
                joints.append(JointSpec(
                    kind=kind, body=name_prefix, pos=jpos.copy(),
                    axis=axis,
                    range=(float(rng[0]), float(rng[1])) if rng is not None
                    else (0.0, 0.0),
                    damping=float(child.attrib.get("damping", "0")),
                    stiffness=float(child.attrib.get("stiffness", "0")),
                    springref=float(child.attrib.get("springref", "0")),
                ))
            elif child.tag in ("worldbody", "mujoco", "mujocoinclude"):
                walk(child, pos, R, name_prefix, childclass)

    # include resolution can leave several worldbody blocks at the top
    # level (each included scene contributes its own) — walk them all
    for wb in root.findall("worldbody"):
        walk(wb, np.zeros(3), np.eye(3), "world", None)
    if root.tag == "mujocoinclude":  # bare asset include
        walk(root, np.zeros(3), np.eye(3), "world", None)

    return MJCFModel(bodies=bodies, geoms=geoms, joints=joints)

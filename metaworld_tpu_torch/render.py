"""Minimal host-side visualizer (rgb_array and depth_array render modes).

Counterpart of `metaworld_tpu/render.py`, line for line: the reference
renders through MuJoCo's native OpenGL stack (GLFW/OSMesa/EGL, cameras in
xyz_base.xml:16-20); throughput training never renders, so this is a
lightweight parity surface in numpy: a top-down orthographic rasterization
of the state (table, hole, static boxes, objects, pads, target) and a ray
caster for the perspective cameras. The public functions take a task spec
and a 1-slot `EnvState` (slot 0 is drawn); its tensors are copied to the
host once per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.physics import engine, maths
from metaworld_tpu_torch.types import ObjType, tree_map

W, H = 480, 480
# world window: x in [-0.6, 0.6], y in [0.2, 1.1]
X0, X1 = -0.6, 0.6
Y0, Y1 = 0.2, 1.1


def _to_px(x, y):
    px = (x - X0) / (X1 - X0) * (W - 1)
    py = (1.0 - (y - Y0) / (Y1 - Y0)) * (H - 1)
    return int(px), int(py)


def _disk(img, cx, cy, r_px, color):
    x0, x1 = max(cx - r_px, 0), min(cx + r_px + 1, W)
    y0, y1 = max(cy - r_px, 0), min(cy + r_px + 1, H)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r_px ** 2
    img[y0:y1, x0:x1][mask] = color


def _rect(img, cx, cy, hx_px, hy_px, color):
    x0, x1 = max(cx - hx_px, 0), min(cx + hx_px + 1, W)
    y0, y1 = max(cy - hy_px, 0), min(cy + hy_px + 1, H)
    if x0 < x1 and y0 < y1:
        img[y0:y1, x0:x1] = color


def _r_px(r):
    return max(int(r / (X1 - X0) * W), 2)


def _host(state):
    """Slot 0 of a 1-slot EnvState as numpy arrays."""
    return tree_map(lambda t: t[0].detach().cpu().numpy(), state)


def _handles(spec, st) -> np.ndarray:
    """(MAX_JOINT, 3) fixture handle positions of a host state, float32
    (engine.fixture_handle_pos on the CPU)."""
    return engine.fixture_handle_pos(
        spec.consts("cpu").scene, torch.from_numpy(st.sim.fixture_pos),
        torch.from_numpy(st.sim.joint_q)).numpy()


def render_state(spec, state) -> np.ndarray:
    """Rasterize slot 0 of an EnvState to (H, W, 3) uint8 (top-down view)."""
    return _render_top(spec, _host(state))


def _render_top(spec, state) -> np.ndarray:
    img = np.full((H, W, 3), 235, dtype=np.uint8)
    # table
    tx0, ty0 = _to_px(-0.55, 1.0)
    tx1, ty1 = _to_px(0.55, 0.25)
    img[ty0:ty1, tx0:tx1] = (205, 185, 150)

    scene = spec.scene
    fixture = np.asarray(state.sim.fixture_pos)

    # hole
    hs = np.asarray(scene.hole_halfsize)
    if (hs > 0).any():
        hc = np.asarray(scene.hole_center)
        cx, cy = _to_px(hc[0], hc[1])
        _rect(img, cx, cy, _r_px(hs[0]), _r_px(hs[1]), (90, 70, 50))

    # static boxes
    for i in range(scene.static_exists.shape[0]):
        if scene.static_exists[i] <= 0:
            continue
        pos = np.asarray(scene.static_pos[i]) + (
            fixture if scene.static_rel[i] > 0 else 0.0
        )
        cx, cy = _to_px(pos[0], pos[1])
        _rect(img, cx, cy, _r_px(scene.static_size[i][0]),
              _r_px(scene.static_size[i][1]), (120, 120, 130))

    # target
    t = np.asarray(state.target)
    cx, cy = _to_px(t[0], t[1])
    _disk(img, cx, cy, 5, (220, 40, 40))

    # objects
    obj = np.asarray(state.sim.obj_pos)
    for i in range(obj.shape[0]):
        if scene.obj_exists[i] <= 0:
            continue
        cx, cy = _to_px(obj[i, 0], obj[i, 1])
        shade = int(np.clip(80 + obj[i, 2] * 400, 0, 255))
        _disk(img, cx, cy, _r_px(float(scene.obj_radius[i])),
              (40, shade, 220))

    # fixture handles
    handles = _handles(spec, state)
    for i in range(handles.shape[0]):
        if scene.joint_exists[i] <= 0:
            continue
        cx, cy = _to_px(handles[i, 0], handles[i, 1])
        _disk(img, cx, cy, 4, (250, 160, 30))

    # gripper pads
    hand = np.asarray(state.sim.hand)
    gap = float(state.sim.gripper) * 0.1 - 0.006
    for s in (-1.0, 1.0):
        cx, cy = _to_px(hand[0], hand[1] + s * gap / 2)
        _disk(img, cx, cy, 3, (30, 30, 30))
    cx, cy = _to_px(hand[0], hand[1])
    _disk(img, cx, cy, 2, (0, 200, 0))

    return img


# ---------------------------------------------------------------------------
# perspective cameras + depth (ref xyz_base.xml:16-20,152-153, docs/rendering)
# ---------------------------------------------------------------------------
#
# Geometry-true software ray caster: per-pixel rays against the actual
# scene primitives (bounded table plane with pit cutout, axis-aligned
# static boxes, sphere/cylinder-ish objects, pad boxes, fixture handles),
# fully vectorized over the pixel grid. Any resolution; exact depth.

# camera name -> (position, look_at, fovy_deg); positions from the
# reference MJCF (xyz_base.xml:16-20); behindGripper/gripperPOV track the
# live hand (xyz_base.xml:152-153)
CAMERAS = {
    "corner": (np.array([-1.1, -0.4, 0.6]), np.array([0.0, 0.6, 0.15]), 45.0),
    "corner2": (np.array([1.3, -0.2, 1.1]), np.array([0.0, 0.65, 0.1]), 60.0),
    "corner3": (np.array([0.9, 0.0, 1.5]), np.array([0.0, 0.65, 0.0]), 45.0),
    "corner4": (np.array([0.75, 0.075, 0.7]), np.array([-0.1, 0.7, 0.1]), 60.0),
    "behindGripper": (None, None, 60.0),
    "gripperPOV": (None, None, 90.0),
}


def _view(cam_pos, look_at):
    fwd = look_at - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    ref_up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ ref_up) > 0.98:  # straight up/down: use +y as up reference
        ref_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, ref_up)
    right = right / max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    return np.stack([right, up, fwd]), cam_pos


def _scene_boxes(spec, state):
    """Axis-aligned boxes [(lo(3), hi(3), rgb)] of the live scene."""
    scene = spec.scene
    fixture = np.asarray(state.sim.fixture_pos)
    boxes = []
    for i in range(scene.static_exists.shape[0]):
        if scene.static_exists[i] <= 0:
            continue
        pos = np.asarray(scene.static_pos[i]) + (
            fixture if scene.static_rel[i] > 0 else 0.0)
        size = np.asarray(scene.static_size[i])
        boxes.append((pos - size, pos + size, (120, 120, 130)))
    # gripper pads (thin vertical plates, ref xyz_base.xml:171,183)
    pad_half = np.array([0.015, 0.0045, 0.045])
    for pad in (np.asarray(state.sim.pad_l), np.asarray(state.sim.pad_r)):
        boxes.append((pad - pad_half, pad + pad_half, (40, 40, 40)))
    return boxes


def _scene_spheres(spec, state):
    """Spheres [(center(3), r, rgb)]: ball objects, handles, target, wrist."""
    scene = spec.scene
    spheres = []
    t = np.asarray(state.target)
    spheres.append((t, 0.015, (220, 40, 40)))
    obj = np.asarray(state.sim.obj_pos)
    for i in range(obj.shape[0]):
        if scene.obj_exists[i] > 0 and int(scene.obj_type[i]) == ObjType.SPHERE:
            spheres.append((obj[i], float(scene.obj_radius[i]), (40, 90, 220)))
    handles = _handles(spec, state)
    for i in range(handles.shape[0]):
        if scene.joint_exists[i] > 0:
            spheres.append((handles[i], float(scene.joint_handle_radius[i]),
                            (250, 160, 30)))
    hand = np.asarray(state.sim.hand)
    spheres.append((hand + np.array([0.0, 0.0, 0.09]), 0.03, (70, 70, 75)))
    return spheres


_LIGHT = np.array([0.35, -0.5, 0.8])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)


def _scene_obbs(spec, state):
    """Oriented boxes [(center, half(3), R(3,3), rgb)]: non-sphere objects
    drawn with their live delta rotation (pucks, blocks, tools)."""
    scene = spec.scene
    obbs = []
    obj = np.asarray(state.sim.obj_pos)
    quat = np.asarray(state.sim.obj_quat)
    for i in range(obj.shape[0]):
        if scene.obj_exists[i] <= 0 or int(scene.obj_type[i]) == ObjType.SPHERE:
            continue
        r = float(scene.obj_radius[i])
        h = float(scene.obj_half_h[i])
        R = maths.quat_to_mat(torch.from_numpy(quat[i])).numpy()
        obbs.append((obj[i], np.array([r, r, h]), R, (40, 90, 220)))
    return obbs


def render_camera(spec, state, camera: str = "corner", width: int = W,
                  height: int = H, depth: bool = False) -> np.ndarray:
    """Render from a named camera (topview/corner/corner2/corner3/corner4/
    behindGripper/gripperPOV — the reference's camera set, ref
    xyz_base.xml:16-20,152-153 and width/height kwargs of _init_each_env,
    ref __init__.py:407-410). Returns (height, width, 3) uint8 rgb, or
    (height, width) float32 view-ray depth in meters when depth=True."""
    state = _host(state)
    if camera == "topview":
        assert not depth, "topview is the orthographic rasterizer (rgb only)"
        img = _render_top(spec, state)
        if (height, width) != img.shape[:2]:
            ys = (np.arange(height) * img.shape[0] // height)
            xs = (np.arange(width) * img.shape[1] // width)
            img = img[ys][:, xs]
        return img
    hand = np.asarray(state.sim.hand)
    if camera == "behindGripper":
        cam_pos, look, fovy = hand + np.array([0.0, -0.05, 0.55]), hand, 60.0
    elif camera == "gripperPOV":
        cam_pos = hand + np.array([0.0, -0.07, 0.07])
        look, fovy = hand + np.array([0.0, 0.25, -0.12]), 90.0
    else:
        cam_pos, look, fovy = CAMERAS[camera]
    R, C = _view(cam_pos, look)

    # pixel ray grid
    focal = 0.5 * height / np.tan(np.radians(fovy) / 2.0)
    xs = (np.arange(width) - width / 2 + 0.5) / focal
    ys = -(np.arange(height) - height / 2 + 0.5) / focal
    u, v = np.meshgrid(xs, ys)
    dirs = np.stack([u, v, np.ones_like(u)], axis=-1) @ R
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = dirs.reshape(-1, 3)
    n_pix = d.shape[0]

    t_hit = np.full(n_pix, np.inf)
    col = np.full((n_pix, 3), 235.0)
    nrm = np.zeros((n_pix, 3))

    def consider(t, mask, normal, color):
        m = mask & (t < t_hit) & (t > 1e-4)
        t_hit[m] = t[m]
        col[m] = color
        nrm[m] = normal if normal.ndim == 1 else normal[m]

    # table top (z=0 rect, pit cutout) and pit floor
    scene = spec.scene
    hs = np.asarray(scene.hole_halfsize)
    hc = np.asarray(scene.hole_center)
    pit = float(scene.pit_depth)
    dz = d[:, 2]
    ok = np.abs(dz) > 1e-9
    for plane_z, color in ((0.0, (205, 185, 150)),
                           (-pit if (hs > 0).any() else None, (90, 70, 50))):
        if plane_z is None:
            continue
        t = np.where(ok, (plane_z - C[2]) / np.where(ok, dz, 1.0), np.inf)
        pt = C[None, :] + t[:, None] * d
        on_table = ((np.abs(pt[:, 0]) <= 0.55)
                    & (pt[:, 1] >= 0.25) & (pt[:, 1] <= 1.0))
        if plane_z == 0.0 and (hs > 0).any():
            in_hole = ((np.abs(pt[:, 0] - hc[0]) <= hs[0])
                       & (np.abs(pt[:, 1] - hc[1]) <= hs[1]))
            on_table &= ~in_hole
        consider(t, ok & on_table & (t > 0), np.array([0.0, 0.0, 1.0]), color)

    # axis-aligned boxes (slab test, vectorized over pixels)
    for lo, hi, color in _scene_boxes(spec, state):
        inv = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
        t0 = (lo[None, :] - C[None, :]) * inv
        t1 = (hi[None, :] - C[None, :]) * inv
        tmin = np.minimum(t0, t1)
        tmax = np.maximum(t0, t1)
        t_near = tmin.max(axis=1)
        t_far = tmax.min(axis=1)
        hit = (t_near <= t_far) & (t_far > 0)
        axis = np.argmax(tmin, axis=1)
        normal = -np.sign(d[np.arange(n_pix), axis])[:, None] * np.eye(3)[axis]
        consider(np.where(hit, np.maximum(t_near, 1e-4), np.inf), hit,
                 normal, color)

    # oriented boxes (objects with live rotation): slab test in box frame
    for c0, half, Rb, color in _scene_obbs(spec, state):
        q0 = (C - c0) @ Rb            # ray origin in box frame
        dq = d @ Rb                   # ray dirs in box frame
        inv = 1.0 / np.where(np.abs(dq) > 1e-12, dq, 1e-12)
        t0 = (-half[None, :] - q0[None, :]) * inv
        t1 = (half[None, :] - q0[None, :]) * inv
        tmin = np.minimum(t0, t1)
        tmax = np.maximum(t0, t1)
        t_near = tmin.max(axis=1)
        t_far = tmax.min(axis=1)
        hit = (t_near <= t_far) & (t_far > 0)
        axis = np.argmax(tmin, axis=1)
        n_local = -np.sign(dq[np.arange(n_pix), axis])[:, None] * np.eye(3)[axis]
        consider(np.where(hit, np.maximum(t_near, 1e-4), np.inf), hit,
                 n_local @ Rb.T, color)

    # spheres
    for c0, r, color in _scene_spheres(spec, state):
        oc = C - c0
        b = d @ oc
        disc = b * b - (oc @ oc - r * r)
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = np.where(-b - sq > 1e-4, -b - sq, -b + sq)
        pt = C[None, :] + t[:, None] * d
        normal = (pt - c0[None, :]) / max(r, 1e-9)
        consider(np.where(hit, t, np.inf), hit, normal, color)

    if depth:
        z = t_hit.reshape(height, width).astype(np.float32)
        z[~np.isfinite(z)] = 0.0
        return z
    shade = 0.6 + 0.4 * np.clip(nrm @ _LIGHT, 0.0, 1.0)
    shade[~np.isfinite(t_hit)] = 1.0
    out = np.clip(col * shade[:, None], 0, 255).astype(np.uint8)
    return out.reshape(height, width, 3)

// One physics substep of the lane engine, per env, in float32.
//
// Translation of metaworld_tpu/physics/engine_lanes.py::_substep (the body
// the Pallas kernel pallas_step._make_kernel runs FRAME_SKIP times). Every
// function here is __host__ __device__: the CUDA kernel (step_kernel.cu)
// runs it with one thread per env, and a host build (host_step.cpp, g++)
// runs the same arithmetic on the CPU so tests can hold it against the
// PyTorch lane engine without a GPU.
//
// Numerics follow the reference: float32 throughout (every literal carries
// an f suffix; constants that the Python code folds in double precision are
// folded in double here and cast once), the polynomial atan2, maximum /
// minimum / clip that propagate NaN (the fused engine's non-finite guard
// relies on a NaN reaching the state), and sign(0) == 0.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define MW_HD __host__ __device__
#define MW_HDI __host__ __device__ __forceinline__
#else
#define MW_HD
#define MW_HDI inline
#endif
// Full unrolling of the fixed-count loops over objects, joints, boxes and
// sides: rolled, their per-slot arrays are indexed at run time and live in
// local memory (a 1 KB stack frame per thread on sm_90a); unrolled, they
// stay in registers. It changes no operation or its order.
#ifdef __CUDACC__
#define MW_UNROLL _Pragma("unroll")
#else
#define MW_UNROLL
#endif
#ifdef __CUDA_ARCH__
#define MW_LDG(p) __ldg(p)
#else
#define MW_LDG(p) (*(p))
#endif

namespace mw {

constexpr int MAX_OBJ = 2;
constexpr int MAX_JOINT = 2;
constexpr int MAX_STATIC = 6;
constexpr int FRAME_SKIP = 5;

// Packed scene rows (pallas_step._SC_SPEC order). "lv3" fields hold three
// rows per slot (slot-major), "lv2" two.
enum ScRow : int {
  O_EXISTS = 0, O_TYPE = 2, O_RADIUS = 4, O_HALF_X = 6, O_OO_HALF_X = 8,
  O_GRASP_X_TOL = 10, O_HALF_H = 12, O_GRASPABLE = 14, O_GHW = 16,
  O_ANCHORED = 18, O_TOOL_OFF = 20, O_DROOP = 26, O_GRASP_OFF = 28,
  O_PLANAR = 34, O_XY_LIMITED = 36, O_XY_LO = 38, O_XY_HI = 42, O_HOOKG = 46,
  LINK_ENABLE = 48, LINK_HANDLE_OFF = 49,
  J_EXISTS = 52, J_AXIS = 54, J_ANCHOR = 60, J_ARM = 66, J_RANGE = 72,
  J_DAMPING = 76, J_STIFFNESS = 78, J_SPRINGREF = 80, J_INERTIA = 82,
  J_BIAS = 84, J_MASS = 86, J_COM = 88, J_HANDLE_RADIUS = 94,
  J_FACE_RADIUS = 96, J_PRESS_OFF = 98, J_FACE_DIR = 104, J_HOOK_CARRY = 110,
  J_HOOKABLE = 112, J_PANEL_OFF = 114, J_PANEL = 116,
  S_EXISTS = 118, S_POS = 124, S_SIZE = 142, S_REL = 160,
  HOLE_C = 166, HOLE_H = 168, PIT_DEPTH = 170, TABLE_Z_ROW = 171,
  IS_SPHERE = 172, IS_HINGE = 174, BLK = 176, HAS_BAR = 182, LEVER = 184,
  VISC = 186, BLEND = 188, FRIC = 190, SPHERE_DN = 192, J_DECAY = 194,
  J_OFF_CAP = 196, SC_ROWS = 198
};

// Packed state rows (pallas_step._SIM_SPEC order).
enum SimRow : int {
  R_HAND = 0, R_HAND_VEL = 3, R_GRIPPER = 6, R_GRIPPER_VEL = 7,
  R_OBJ_POS = 8, R_OBJ_QUAT = 14, R_OBJ_VEL = 22, R_OBJ_ANGVEL = 28,
  R_JOINT_Q = 34, R_JOINT_V = 36, R_ATTACHED = 38, R_ATTACH_OFF = 40,
  R_UNANCHORED = 46, R_HOOKED = 48, R_HOOK_OFF = 50, R_HOOK_HOFF = 52,
  R_PAD_FORCE_L = 58, R_PAD_FORCE_R = 59, R_FIXTURE_POS = 60, SIM_ROWS = 63
};

// ---------------------------------------------------------------------------
// constants (engine.py / engine_lanes.py of the JAX package)
// ---------------------------------------------------------------------------

constexpr double DT_D = 0.0025;
constexpr float DT = 0.0025f;
constexpr float BIG_QV = 1e9f;
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float HALF_PI_F = (float)(3.14159265358979323846 / 2.0);
constexpr float GRIPPER_FULL_OPEN = 0.1f;
constexpr float PAD_Z_OFFSET = 0.045f;
constexpr float PAD_GAP_INSET = 0.006f;
constexpr float HAND_VMAX = 1.2f;
constexpr float HAND_W2 = (float)(40.0 * 40.0);
constexpr float HAND_2ZW = (float)(2.0 * 1.0 * 40.0);
constexpr float F_KP = 400.0f;
constexpr float F_DAMP = 1000.0f;
constexpr float F_MASS = 100.0f;
constexpr float R_LO = 0.0f, R_HI = 0.04f, L_LO = -0.03f, L_HI = 0.0f;
constexpr float HAND_TIP_R = 0.005f;
constexpr float HAND_KNUCKLE_R = 0.03f;
constexpr float PAD_TIP_BEVEL = 0.008f;
constexpr float WELD_K = 600.0f;
constexpr float HOOK_SLIP = 0.13f;
constexpr float HOOK_SLIP_ENGAGE = (float)(0.13 - 0.03);
constexpr float HOOK_SLIP_2 = (float)(2.0 * 0.13);
constexpr float K_SLIDE_LIM = 400.0f;
constexpr float GRASP_XZ_TOL = 0.035f;
constexpr float GRASP_Z_SPAN = 0.09f;
constexpr float GRAVITY = 9.81f;
constexpr float G_DT = (float)(9.81 * 0.0025);
constexpr float MU_HAND = 1.0f;
constexpr float MU_TABLE = 1.5f;
constexpr float SQUEEZE_CREEP_DT = (float)(0.055 * 0.0025);
constexpr float MIN_GAP = (float)(0.1 - (0.04 - (-0.03)));
constexpr float K_QR = (float)(0.04 / 0.07);
constexpr float K_QL = (float)(0.03 / 0.07);
constexpr float PAD_K = 4000.0f;
constexpr float TCP_MID_Z = (float)(0.045 * 0.6);
constexpr float DQ_CAP_STEP = (float)(4.0 * 0.0025);
constexpr float NEG_DQ_CAP_STEP = (float)(-4.0 * 0.0025);
constexpr float BUDGET_FLOOR = (float)(1e-3 * 0.0025);
// exp-based relaxations of engine_lanes.py:525-532, evaluated in double
// as the Python module does (1 - exp(-dt / tau), exp(-dt / tau))
constexpr float SETTLE = (float)0.048770575499285984;
constexpr float SETTLE_DN = (float)0.012422199506118559;
constexpr float OMEGA_DECAY = (float)0.9394130628134758;
constexpr float ALPHA_R = (float)0.03076676552365587;
constexpr float ALPHA_D = (float)0.007117407569049661;
constexpr float WEDGE_A = (float)0.01652854617838251;
constexpr float D_SLIDE_DECAY = (float)0.07225651367144714;
constexpr float ONE_MINUS_SETTLE = (float)0.951229424500714;
// TCP offset of the weld (engine.TCP_OFFSET, float32 values)
constexpr float TCPO_X = 0.0044f, TCPO_Y = 0.0015f, TCPO_Z = -0.0498f;

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

MW_HDI float mx(float a, float b) { return (a > b || a != a) ? a : b; }
MW_HDI float mn(float a, float b) { return (a < b || a != a) ? a : b; }
MW_HDI float clip(float x, float lo, float hi) { return mn(mx(x, lo), hi); }
MW_HDI float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}
MW_HDI float b2f(bool b) { return b ? 1.0f : 0.0f; }
MW_HDI float sel(bool c, float a, float b) { return c ? a : b; }
// jnp.mod: floored remainder built on the exact fmod
MW_HDI float fmod_floor(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = r + b;
  return r;
}
MW_HDI float wrap_pi(float x) { return fmod_floor(x + PI_F, TWO_PI_F) - PI_F; }

MW_HDI float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float m = mx(ax, ay);
  float n = mn(ax, ay);
  float z = n / mx(m, 1e-30f);
  float s = z * z;
  float p = 0.00282363896258175373077393f;
  p = p * s - 0.0159569028764963150024414f;
  p = p * s + 0.0425049886107444763183594f;
  p = p * s - 0.0748900920152664184570312f;
  p = p * s + 0.106347933411598205566406f;
  p = p * s - 0.142027363181114196777344f;
  p = p * s + 0.199926957488059997558594f;
  p = p * s - 0.333331018686294555664062f;
  float a = z + z * s * p;
  a = sel(ay > ax, HALF_PI_F - a, a);
  a = sel(x < 0.0f, PI_F - a, a);
  return sel(y < 0.0f, -a, a);
}

// first-min-wins picks over three values (argmin order)
struct Pick { bool p0, p1; };
MW_HDI Pick argmin3(float d0, float d1, float d2) {
  bool p0 = (d0 <= d1) && (d0 <= d2);
  bool p1 = (!p0) && (d1 <= d2);
  return {p0, p1};
}
MW_HDI float sel3(Pick k, float v0, float v1, float v2) {
  return k.p0 ? v0 : (k.p1 ? v1 : v2);
}

// ---------------------------------------------------------------------------
// 3-vectors and quaternions
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

MW_HDI V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
MW_HDI V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
MW_HDI V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
MW_HDI float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
MW_HDI V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
MW_HDI float norm3(V3 a) { return sqrtf(mx(dot(a, a), 1e-24f)); }
MW_HDI float norm2(float x, float y) { return sqrtf(mx(x * x + y * y, 1e-24f)); }
MW_HDI V3 sel(bool c, V3 a, V3 b) {
  return {c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z};
}
MW_HDI Q4 sel(bool c, Q4 a, Q4 b) {
  return {c ? a.w : b.w, c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z};
}
MW_HDI V3 safe_normalize(V3 v) {
  float n = sqrtf(mx(dot(v, v), 1e-24f));
  float inv = 1.0f / mx(n, 1e-9f);
  return v * inv;
}
MW_HDI Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
MW_HDI V3 qrot(Q4 q, V3 v) {
  Q4 t = qmul(q, Q4{0.0f, v.x, v.y, v.z});
  Q4 o = qmul(t, Q4{q.w, -q.x, -q.y, -q.z});
  return {o.x, o.y, o.z};
}
MW_HDI Q4 axquat(V3 axis, float angle) {
  float half = angle / 2.0f;
  float s = sinf(half);
  return {cosf(half), axis.x * s, axis.y * s, axis.z * s};
}
MW_HDI float dot4(Q4 a, Q4 b) {
  return a.w * b.w + a.x * b.x + a.y * b.y + a.z * b.z;
}
MW_HDI Q4 qnorm(Q4 q) {
  float inv = 1.0f / sqrtf(mx(dot4(q, q), 1e-24f));
  return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}
MW_HDI Q4 qintegrate(Q4 q, V3 om, float dt) {
  Q4 dq{0.0f, om.x * dt, om.y * dt, om.z * dt};
  Q4 m = qmul(dq, q);
  return qnorm(Q4{q.w + 0.5f * m.w, q.x + 0.5f * m.x, q.y + 0.5f * m.y,
                  q.z + 0.5f * m.z});
}
MW_HDI Q4 qnlerp(Q4 q, Q4 p, float alpha) {
  float s = sgn(dot4(q, p) + 1e-30f);
  return qnorm(Q4{q.w + alpha * (p.w * s - q.w), q.x + alpha * (p.x * s - q.x),
                  q.y + alpha * (p.y * s - q.y), q.z + alpha * (p.z * s - q.z)});
}

// ---------------------------------------------------------------------------
// scene view and state
// ---------------------------------------------------------------------------

// One task's scene row in global memory (read-only; a warp mostly reads one
// task's row, so the loads broadcast). Read through the read-only cache:
// staging the block's task rows in shared memory measured no faster on the
// H100 (with plain shared loads ptxas hoists the rows into registers and
// spills; with volatile ones it ties; PERF.md).
struct Scene {
  const float* p;
  MW_HDI float operator()(int r) const { return MW_LDG(p + r); }
  MW_HDI bool b(int r) const { return MW_LDG(p + r) != 0.0f; }
  MW_HDI V3 v3(int r) const { return {(*this)(r), (*this)(r + 1), (*this)(r + 2)}; }
};

struct State {
  V3 hand, hand_vel;
  float gripper, gripper_vel;
  V3 obj_pos[MAX_OBJ];
  Q4 obj_quat[MAX_OBJ];
  V3 obj_vel[MAX_OBJ], obj_angvel[MAX_OBJ];
  float joint_q[MAX_JOINT], joint_v[MAX_JOINT];
  float attached[MAX_OBJ];
  V3 attach_off[MAX_OBJ];
  float unanchored[MAX_OBJ];
  float hooked[MAX_JOINT], hook_off[MAX_JOINT];
  V3 hook_hoff[MAX_JOINT];
  float pad_force_l, pad_force_r;
  V3 fixture_pos;
};

MW_HDI V3 ld3(const float* r, int row, int stride, int i) {
  return {r[row * stride + i], r[(row + 1) * stride + i], r[(row + 2) * stride + i]};
}
MW_HDI void st3(float* r, int row, int stride, int i, V3 v) {
  r[row * stride + i] = v.x;
  r[(row + 1) * stride + i] = v.y;
  r[(row + 2) * stride + i] = v.z;
}

// state rows (SIM_ROWS, stride) -> env i
MW_HDI State load_state(const float* r, int stride, int i) {
  State s;
  s.hand = ld3(r, R_HAND, stride, i);
  s.hand_vel = ld3(r, R_HAND_VEL, stride, i);
  s.gripper = r[R_GRIPPER * stride + i];
  s.gripper_vel = r[R_GRIPPER_VEL * stride + i];
  MW_UNROLL for (int k = 0; k < MAX_OBJ; ++k) {
    s.obj_pos[k] = ld3(r, R_OBJ_POS + 3 * k, stride, i);
    int q = R_OBJ_QUAT + 4 * k;
    s.obj_quat[k] = {r[q * stride + i], r[(q + 1) * stride + i],
                     r[(q + 2) * stride + i], r[(q + 3) * stride + i]};
    s.obj_vel[k] = ld3(r, R_OBJ_VEL + 3 * k, stride, i);
    s.obj_angvel[k] = ld3(r, R_OBJ_ANGVEL + 3 * k, stride, i);
    s.attached[k] = r[(R_ATTACHED + k) * stride + i];
    s.attach_off[k] = ld3(r, R_ATTACH_OFF + 3 * k, stride, i);
    s.unanchored[k] = r[(R_UNANCHORED + k) * stride + i];
  }
  MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
    s.joint_q[j] = r[(R_JOINT_Q + j) * stride + i];
    s.joint_v[j] = r[(R_JOINT_V + j) * stride + i];
    s.hooked[j] = r[(R_HOOKED + j) * stride + i];
    s.hook_off[j] = r[(R_HOOK_OFF + j) * stride + i];
    s.hook_hoff[j] = ld3(r, R_HOOK_HOFF + 3 * j, stride, i);
  }
  s.pad_force_l = r[R_PAD_FORCE_L * stride + i];
  s.pad_force_r = r[R_PAD_FORCE_R * stride + i];
  s.fixture_pos = ld3(r, R_FIXTURE_POS, stride, i);
  return s;
}

MW_HDI void store_state(float* r, int stride, int i, const State& s) {
  st3(r, R_HAND, stride, i, s.hand);
  st3(r, R_HAND_VEL, stride, i, s.hand_vel);
  r[R_GRIPPER * stride + i] = s.gripper;
  r[R_GRIPPER_VEL * stride + i] = s.gripper_vel;
  MW_UNROLL for (int k = 0; k < MAX_OBJ; ++k) {
    st3(r, R_OBJ_POS + 3 * k, stride, i, s.obj_pos[k]);
    int q = R_OBJ_QUAT + 4 * k;
    r[q * stride + i] = s.obj_quat[k].w;
    r[(q + 1) * stride + i] = s.obj_quat[k].x;
    r[(q + 2) * stride + i] = s.obj_quat[k].y;
    r[(q + 3) * stride + i] = s.obj_quat[k].z;
    st3(r, R_OBJ_VEL + 3 * k, stride, i, s.obj_vel[k]);
    st3(r, R_OBJ_ANGVEL + 3 * k, stride, i, s.obj_angvel[k]);
    r[(R_ATTACHED + k) * stride + i] = s.attached[k];
    st3(r, R_ATTACH_OFF + 3 * k, stride, i, s.attach_off[k]);
    r[(R_UNANCHORED + k) * stride + i] = s.unanchored[k];
  }
  MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
    r[(R_JOINT_Q + j) * stride + i] = s.joint_q[j];
    r[(R_JOINT_V + j) * stride + i] = s.joint_v[j];
    r[(R_HOOKED + j) * stride + i] = s.hooked[j];
    r[(R_HOOK_OFF + j) * stride + i] = s.hook_off[j];
    st3(r, R_HOOK_HOFF + 3 * j, stride, i, s.hook_hoff[j]);
  }
  r[R_PAD_FORCE_L * stride + i] = s.pad_force_l;
  r[R_PAD_FORCE_R * stride + i] = s.pad_force_r;
  st3(r, R_FIXTURE_POS, stride, i, s.fixture_pos);
}

// ---------------------------------------------------------------------------
// geometry (engine_lanes.py:437-516)
// ---------------------------------------------------------------------------

MW_HDI float support_z(const Scene& sc, float x, float y) {
  float base = 0.0f + sc(TABLE_Z_ROW);
  bool in_hole = (fabsf(x - sc(HOLE_C)) < sc(HOLE_H)) &&
                 (fabsf(y - sc(HOLE_C + 1)) < sc(HOLE_H + 1));
  bool has_hole = (sc(HOLE_H) > 0.0f) || (sc(HOLE_H + 1) > 0.0f);
  return (has_hole && in_hole) ? base - sc(PIT_DEPTH) : base;
}

struct Push { V3 corr, n; float pen; };

MW_HDI Push sphere_box_pushout(V3 p, float r, V3 bp, V3 bs) {
  V3 d = p - bp;
  V3 cl = {clip(d.x, -bs.x, bs.x), clip(d.y, -bs.y, bs.y), clip(d.z, -bs.z, bs.z)};
  V3 delta = d - cl;
  float dist = norm3(delta);
  float inv = 1.0f / mx(dist, 1e-9f);
  V3 n_out = delta * inv;
  float pen_out = mx(r - dist, 0.0f);
  bool inside = dist < 1e-9f;
  float dep0 = bs.x - fabsf(d.x) + r;
  float dep1 = bs.y - fabsf(d.y) + r;
  float dep2 = bs.z - fabsf(d.z) + r;
  Pick k = argmin3(dep0, dep1, dep2);
  float d_axis = sel3(k, d.x, d.y, d.z);
  float s = sgn(d_axis) + b2f(d_axis == 0.0f);
  V3 n_in = {sel(k.p0, s, 0.0f), sel(k.p1, s, 0.0f), sel(k.p0 || k.p1, 0.0f, s)};
  float pen_in = sel3(k, dep0, dep1, dep2);
  V3 n = sel(inside, n_in, n_out);
  float pen = sel(inside, pen_in, pen_out);
  return {n * pen, n, pen};
}

MW_HDI void pad_centers(V3 hand, float gripper, V3& left, V3& right) {
  float gap = gripper * GRIPPER_FULL_OPEN - PAD_GAP_INSET;
  float half = gap / 2.0f;
  float up = hand.z + PAD_Z_OFFSET;
  left = {hand.x, hand.y + half, up};
  right = {hand.x, hand.y - half, up};
}

MW_HDI V3 handle_pos(const Scene& sc, int j, V3 fixture, float q) {
  V3 axis = sc.v3(J_AXIS + 3 * j);
  V3 anchor = fixture + sc.v3(J_ANCHOR + 3 * j);
  V3 slide = anchor + axis * q;
  V3 arm = qrot(axquat(axis, q), sc.v3(J_ARM + 3 * j));
  V3 hinge = anchor + arm;
  return sel(sc.b(IS_HINGE + j), hinge, slide);
}

MW_HDI V3 motion_dir(const Scene& sc, int j, float q) {
  V3 axis = sc.v3(J_AXIS + 3 * j);
  V3 arm = qrot(axquat(axis, q), sc.v3(J_ARM + 3 * j));
  V3 tangent = safe_normalize(cross(axis, arm));
  V3 axis_n = safe_normalize(axis);
  return sel(sc.b(IS_HINGE + j), tangent, axis_n);
}

MW_HDI float fixture_inverse(const Scene& sc, int j, V3 fixture, V3 point) {
  V3 anchor = fixture + sc.v3(J_ANCHOR + 3 * j);
  V3 rel = point - anchor;
  V3 axis = sc.v3(J_AXIS + 3 * j);
  float q_slide = dot(rel, axis);
  V3 rel_p = rel - axis * dot(rel, axis);
  V3 arm0 = sc.v3(J_ARM + 3 * j);
  V3 arm_p = arm0 - axis * dot(arm0, axis);
  float cosq = dot(rel_p, arm_p);
  float sinq = dot(cross(arm_p, rel_p), axis);
  float q_hinge = atan2_poly(sinq, (fabsf(sinq) + fabsf(cosq)) < 1e-12f ? 1.0f : cosq);
  return sel(sc.b(IS_HINGE + j), q_hinge, q_slide);
}

MW_HDI V3 static_box_pos(const Scene& sc, int s, V3 fixture) {
  return sc.v3(S_POS + 3 * s) + fixture * sc(S_REL + s);
}



// ---------------------------------------------------------------------------
// the substep (engine_lanes.py:540-1676)
// ---------------------------------------------------------------------------

// engine.py:366-386 one_p: pad plate AABB vs scene box
MW_HDI V3 pad_box_corr(V3 pc, V3 bp, V3 bs, float on) {
  V3 d = pc - bp;
  float pen0 = 0.015f + bs.x - fabsf(d.x);
  float pen1 = 0.0045f + bs.y - fabsf(d.y);
  float pen2 = 0.045f + bs.z - fabsf(d.z);
  bool hit = pen0 > 0.0f && pen1 > 0.0f && pen2 > 0.0f && on > 0.0f;
  Pick k = argmin3(pen0, pen1, pen2);
  float pen_h = mn(pen0, pen1);
  bool use_h = pen_h < PAD_TIP_BEVEL;
  bool h0 = pen0 <= pen1;
  Pick p{(use_h && h0) || (!use_h && k.p0), (use_h && !h0) || (!use_h && k.p1)};
  float d_axis = sel3(p, d.x, d.y, d.z);
  float s = d_axis >= 0.0f ? 1.0f : -1.0f;
  float mag = hit ? sel3(p, pen0, pen1, pen2) : 0.0f;
  return {sel(p.p0, mag * s, 0.0f), sel(p.p1, mag * s, 0.0f),
          sel(p.p0 || p.p1, 0.0f, mag * s)};
}

// axis-aligned overlap of two boxes: (correction along the least-penetrated
// axis pointing along d, with magnitude `mag`) -- the pattern shared by the
// pad pushes, the object-object contact and the jams
struct AxisHit { Pick k; float sgn, mag; };
MW_HDI AxisHit axis_hit(V3 d, V3 pen, bool hit) {
  Pick k = argmin3(pen.x, pen.y, pen.z);
  float d_axis = sel3(k, d.x, d.y, d.z);
  float s = d_axis >= 0.0f ? 1.0f : -1.0f;
  float mag = hit ? sel3(k, pen.x, pen.y, pen.z) : 0.0f;
  return {k, s, mag};
}
MW_HDI V3 axis_dir(Pick k, float s) {
  return {sel(k.p0, s, 0.0f), sel(k.p1, s, 0.0f), sel(k.p0 || k.p1, 0.0f, s)};
}
MW_HDI V3 axis_corr(const AxisHit& h) {
  float v = h.mag * h.sgn;
  return {sel(h.k.p0, v, 0.0f), sel(h.k.p1, v, 0.0f), sel(h.k.p0 || h.k.p1, 0.0f, v)};
}

MW_HDI V3 box_contacts(const Scene& sc, const V3* bpos, V3 p, float r) {
  V3 acc = sphere_box_pushout(p, r, bpos[0], sc.v3(S_SIZE)).corr * sc(S_EXISTS);
  MW_UNROLL for (int s = 1; s < MAX_STATIC; ++s)
    acc = acc + sphere_box_pushout(p, r, bpos[s], sc.v3(S_SIZE + 3 * s)).corr
                    * sc(S_EXISTS + s);
  return acc;
}

// Press-contact part: (dq, velocity upper bound, lower bound).
struct Part { float dq, hi, lo; };

// what the joint block needs from the object block
struct ObjOut {
  V3 pos[MAX_OBJ], vel[MAX_OBJ];
  Q4 quat[MAX_OBJ];
};

// Per-joint quantities the press-contact parts read.
struct JointCtx {
  V3 handle, press_pt_off, press_fd, motion;
  float lever, handle_radius, face_radius, range_lo, range_hi, q_free, exists;
  bool has_bar, is_hinge;
};

MW_HDI void vel_bounds(const JointCtx& c, bool live, float side, V3 center, V3 prev,
                       float lv, float weight, float& hi, float& lo) {
  float vn_q = dot(center - prev, c.motion) / DT / lv;
  bool act = live && (weight > 0.25f);
  hi = (act && side > 0.0f) ? vn_q : BIG_QV;
  lo = (act && side < 0.0f) ? vn_q : -BIG_QV;
}

// contact side along the motion axis, from the previous position when it
// is off the face (engine_lanes.py sphere_part / box_part)
MW_HDI float contact_side(float u_prev, float u) {
  float side = fabsf(u_prev) > 1e-9f ? sgn(u_prev) : sgn(u);
  return side == 0.0f ? 1.0f : side;
}

MW_HDI V3 face_point(const JointCtx& c, V3 pt0, V3 center) {
  float s_near = clip(dot(center - pt0, c.press_fd), -c.face_radius, c.face_radius);
  return sel(c.has_bar, pt0 + c.press_fd * s_near, pt0);
}

// `r_part06` is 0.6 * r_part folded in double, as the Python constant is
MW_HDI Part sphere_part(const JointCtx& c, V3 center, V3 prev, float r_part,
                        float r_part06, V3 pt0, float lv, float weight) {
  float face_r = c.handle_radius;
  V3 pt = face_point(c, pt0, center);
  V3 d3 = center - pt;
  float u = dot(d3, c.motion);
  float u_prev = dot(prev - pt, c.motion);
  float side = contact_side(u_prev, u);
  V3 perp = d3 - c.motion * u;
  float pd = norm3(perp);
  float r_sum = face_r + r_part;
  float eff_r = c.has_bar ? sqrtf(mx(r_sum * r_sum - pd * pd, 1e-24f)) : r_sum;
  bool in_face = (c.has_bar && (pd < r_sum)) ||
                 (!c.has_bar && (pd < c.face_radius + r_part06));
  float pen = eff_r - side * u;
  bool live = in_face && (pen > 0.0f) && (side * u > -r_sum);
  float du = dot(center - prev, c.motion);
  float move_cap = mx(-side * du, 0.0f) + 0.0005f;
  pen = mn(pen, move_cap);
  Part p;
  p.dq = weight * (live ? -side * pen : 0.0f) / lv;
  vel_bounds(c, live, side, center, prev, lv, weight, p.hi, p.lo);
  return p;
}

// Extra outputs of a plate part on a disc cap (engine_lanes.py disc_yield).
struct DiscOut { bool soft; float jam_excess; bool hold; Part stop; };

template <bool DISC_YIELD>
MW_HDI Part box_part(const JointCtx& c, V3 center, V3 prev, V3 half, bool bar_only,
                     float weight, DiscOut* dy) {
  V3 pt0 = c.handle + c.press_pt_off;
  V3 pt = face_point(c, pt0, center);
  V3 d3 = center - pt;
  float u = dot(d3, c.motion);
  float u_prev = dot(prev - pt, c.motion);
  float side = contact_side(u_prev, u);
  float h_m = half.x * fabsf(c.motion.x) + half.y * fabsf(c.motion.y) +
              half.z * fabsf(c.motion.z);
  V3 rel = pt - center;
  V3 closest = {clip(rel.x, -half.x, half.x), clip(rel.y, -half.y, half.y),
                clip(rel.z, -half.z, half.z)};
  V3 gap_vec = rel - closest;
  V3 gap_lat = gap_vec - c.motion * dot(gap_vec, c.motion);
  float lat_r = c.has_bar ? c.handle_radius : c.face_radius;
  bool lat_ok = norm3(gap_lat) <= lat_r;
  float depth = h_m + c.handle_radius;
  bool live = lat_ok && (side * u > -depth);
  if (bar_only) live = live && c.has_bar;
  float pen = depth - side * u;
  live = live && (pen > 0.0f);
  float du = dot(center - prev, c.motion);
  pen = mn(pen, mx(-side * du, 0.0f) + 0.0005f);
  Part p;
  p.dq = weight * (live ? -side * pen : 0.0f) / c.lever;
  vel_bounds(c, live, side, center, prev, c.lever, weight, p.hi, p.lo);
  if constexpr (DISC_YIELD) {
    bool rigid = c.has_bar || (fabsf(c.motion.z) >= 0.5f) || c.is_hinge;
    float pen_ns = mn(0.65f * (depth - side * u), mx(-side * du, 0.0f));
    float dq_soft = weight * (live ? -side * pen_ns : 0.0f) / c.lever;
    float room_lo = mn(c.range_lo - c.q_free, 0.0f);
    float room_hi = mx(c.range_hi - c.q_free, 0.0f);
    dq_soft = clip(dq_soft, room_lo, room_hi);
    dy->soft = lat_ok && !rigid && (fabsf(u) < depth + 0.045f) && (c.exists > 0.0f);
    p.dq = rigid ? p.dq : dq_soft;
    float vn_q = dot(center - prev, c.motion) / DT / c.lever;
    bool live_soft = live && !rigid;
    float lo_soft = (live_soft && side < 0.0f) ? mn(vn_q, 0.0f) : -BIG_QV;
    float hi_soft = (live_soft && side > 0.0f) ? mx(vn_q, 0.0f) : BIG_QV;
    p.hi = rigid ? p.hi : hi_soft;
    p.lo = rigid ? p.lo : lo_soft;
    bool faceon = !rigid && (norm3(gap_lat) < 0.005f);
    float excess = u - (0.030f - depth);
    float excess_ej = u - (0.050f - depth);
    bool live_j = faceon && lat_ok && (excess_ej > 0.0f) && (u < 0.105f) && (c.exists > 0.0f);
    dy->jam_excess = live_j ? excess_ej : 0.0f;
    dy->hold = faceon && lat_ok && (excess > -0.005f) && (u < 0.105f) && (c.exists > 0.0f);
    dy->stop = Part{0.0f, BIG_QV, -BIG_QV};
  }
  return p;
}

// Folds parts into (dq_pos, dq_neg, hi, lo) as engine_lanes.py:1383-1394.
struct PartAcc {
  float dq_pos, dq_neg, hi, lo;
  bool first = true;
  MW_HDI void add(const Part& p) {
    if (first) {
      dq_pos = mx(p.dq, 0.0f); dq_neg = mn(p.dq, 0.0f); hi = p.hi; lo = p.lo;
      first = false;
    } else {
      dq_pos = mx(dq_pos, mx(p.dq, 0.0f));
      dq_neg = mn(dq_neg, mn(p.dq, 0.0f));
      hi = mn(hi, p.hi);
      lo = mx(lo, p.lo);
    }
  }
};

template <bool WITH_OBJECTS, bool WITH_JOINTS, bool WITH_HAND_BOXES>
MW_HD State substep(const Scene& sc, const State& st, V3 target, float effort) {
  const float dt = DT;
  const V3 hand0 = st.hand;
  State out = st;

  // --- hand tracking (second-order weld) ---
  V3 vel_h = st.hand_vel;
  V3 acc_h = {HAND_W2 * (target.x - hand0.x) - HAND_2ZW * vel_h.x,
              HAND_W2 * (target.y - hand0.y) - HAND_2ZW * vel_h.y,
              HAND_W2 * (target.z - hand0.z) - HAND_2ZW * vel_h.z};
  vel_h = vel_h + acc_h * dt;
  float vn = norm3(vel_h);
  vel_h = vel_h * mn(1.0f, HAND_VMAX / mx(vn, 1e-9f));
  V3 new_hand = hand0 + vel_h * dt;

  // --- hand vs static geometry ---
  const V3 fixture = st.fixture_pos;
  V3 bpos[MAX_STATIC];
  MW_UNROLL for (int s = 0; s < MAX_STATIC; ++s) bpos[s] = static_box_pos(sc, s, fixture);

  if constexpr (WITH_HAND_BOXES) {
    V3 h = new_hand;
    V3 tip = sphere_box_pushout(h, HAND_TIP_R, bpos[0], sc.v3(S_SIZE)).corr * sc(BLK);
    MW_UNROLL for (int s = 1; s < MAX_STATIC; ++s)
      tip = tip + sphere_box_pushout(h, HAND_TIP_R, bpos[s], sc.v3(S_SIZE + 3 * s)).corr
                      * sc(BLK + s);
    h = h + tip;
    V3 h_up = {h.x, h.y, h.z + 0.105f};
    V3 kn = sphere_box_pushout(h_up, HAND_KNUCKLE_R, bpos[0], sc.v3(S_SIZE)).corr * sc(BLK);
    MW_UNROLL for (int s = 1; s < MAX_STATIC; ++s)
      kn = kn + sphere_box_pushout(h_up, HAND_KNUCKLE_R, bpos[s], sc.v3(S_SIZE + 3 * s)).corr
                    * sc(BLK + s);
    h = h + kn;
    V3 pads[2];
    pad_centers(h, st.gripper, pads[0], pads[1]);
    MW_UNROLL for (int side = 0; side < 2; ++side) {
      V3 corr = pad_box_corr(pads[side], bpos[0], sc.v3(S_SIZE), sc(BLK));
      MW_UNROLL for (int s = 1; s < MAX_STATIC; ++s)
        corr = corr + pad_box_corr(pads[side], bpos[s], sc.v3(S_SIZE + 3 * s), sc(BLK + s));
      h = h + corr;
    }
    V3 raw_hand = new_hand;
    new_hand = h;
    // Coulomb stick/slip pin against blocked boxes
    V3 corr_h = new_hand - raw_hand;
    float cn_h = norm3(corr_h);
    V3 n_h_dir = corr_h * (1.0f / mx(cn_h, 1e-9f));
    V3 dv_h = new_hand - hand0;
    float dvn = dot(dv_h, n_h_dir);
    V3 dv_n_h = n_h_dir * dvn;
    V3 dv_t_h = dv_h - dv_n_h;
    float t_mag = norm3(dv_t_h);
    float t_allow = mx(t_mag - MU_HAND * cn_h, 0.0f);
    float scale_t = cn_h > 1e-9f ? t_allow / mx(t_mag, 1e-9f) : 1.0f;
    new_hand = hand0 + dv_n_h + dv_t_h * scale_t;
  }
  V3 hand_vel = {(new_hand.x - hand0.x) / dt, (new_hand.y - hand0.y) / dt,
              (new_hand.z - hand0.z) / dt};

  // --- grasped-object gap clamp ---
  const float gap0 = st.gripper * GRIPPER_FULL_OPEN;
  bool can_grasp[MAX_OBJ] = {false, false};
  bool squeezed_out[MAX_OBJ] = {false, false};
  float clamp_gap = 0.0f;
  if constexpr (WITH_OBJECTS) {
    float obj_gap[MAX_OBJ];
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 gp = st.obj_pos[i] + sc.v3(O_GRASP_OFF + 3 * i);
      V3 rel = gp - hand0;
      bool between = fabsf(rel.y) < gap0 / 2.0f + 0.01f;
      bool near_x = fabsf(rel.x) < GRASP_XZ_TOL;
      bool near_z = (rel.z > -0.025f) && (rel.z < GRASP_Z_SPAN);
      bool c = between && near_x && near_z;
      bool cg = c && (sc(O_GRASPABLE + i) > 0.0f) && (sc(O_EXISTS + i) > 0.0f);
      bool sq = cg && (st.attached[i] == 0.0f) && (gap0 < sc(O_GHW + i)) &&
                (sc(O_HOOKG + i) == 0.0f);
      squeezed_out[i] = sq;
      can_grasp[i] = cg && !sq;
      obj_gap[i] = (can_grasp[i] || st.attached[i] > 0.0f)
                       ? 2.0f * sc(O_GHW + i) + PAD_GAP_INSET : 0.0f;
    }
    clamp_gap = mx(obj_gap[0], obj_gap[1]);
  }

  // --- gripper ODE ---
  float closed = (GRIPPER_FULL_OPEN - gap0) / GRIPPER_FULL_OPEN;
  float q_r = closed * 0.1f * K_QR;
  float q_l = -closed * 0.1f * K_QL;
  float v = st.gripper_vel * GRIPPER_FULL_OPEN;
  float v_r = -v * K_QR;
  float v_l = v * K_QL;
  float e = clip(effort, -1.0f, 1.0f);
  float acc_r = (F_KP * (e - q_r) - F_DAMP * v_r) / F_MASS;
  float acc_l = (F_KP * (-e - q_l) - F_DAMP * v_l) / F_MASS;
  v_r = v_r + acc_r * dt;
  v_l = v_l + acc_l * dt;
  float q_r_new = clip(q_r + v_r * dt, R_LO, R_HI);
  float q_l_new = clip(q_l + v_l * dt, L_LO, L_HI);
  float new_gap = GRIPPER_FULL_OPEN - (q_r_new - q_l_new);
  float clamped_gap = mx(new_gap, clamp_gap);
  bool binds = clamp_gap > new_gap;
  if constexpr (WITH_OBJECTS) {
    bool hard_clamp = (st.attached[0] > 0.0f) || (st.attached[1] > 0.0f);
    float soft_gap = mx(mn(clamped_gap, gap0 - SQUEEZE_CREEP_DT), MIN_GAP);
    clamped_gap = (hard_clamp || !binds) ? clamped_gap : soft_gap;
  }
  float squeeze = binds ? mx(F_KP * (e - q_r_new), 0.0f) : 0.0f;
  float gripper_vel = binds ? 0.0f : (clamped_gap - gap0) / dt / GRIPPER_FULL_OPEN;
  float gripper = clamped_gap / GRIPPER_FULL_OPEN;

  ObjOut ob;
  float attached[MAX_OBJ];
  V3 attach_off[MAX_OBJ];
  float unanchored[MAX_OBJ];
  V3 omega_out[MAX_OBJ];
  float pad_depth0[2] = {0.0f, 0.0f};  // pad push depth on object 0, per pad

  if constexpr (WITH_OBJECTS) {
    // --- attach / detach ---
    float gap_m = gripper * GRIPPER_FULL_OPEN;
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 go = sc.v3(O_GRASP_OFF + 3 * i);
      bool gripping = (effort > 0.0f) && ((squeeze > 0.0f) || (sc(O_HOOKG + i) > 0.0f));
      bool tight_x = fabsf(st.obj_pos[i].x + go.x - hand0.x) < sc(O_GRASP_X_TOL + i);
      bool newly = can_grasp[i] && tight_x && gripping && (st.attached[i] == 0.0f);
      V3 ao = sel(newly, st.obj_pos[i] - new_hand, st.attach_off[i]);
      float att = newly ? 1.0f : st.attached[i];
      float una = newly ? 1.0f : st.unanchored[i];
      bool release = (effort <= 0.0f) ||
                     ((gap_m > 2.0f * sc(O_GHW + i) + PAD_GAP_INSET + 0.01f) &&
                      (sc(O_HOOKG + i) == 0.0f));
      att = release ? 0.0f : att;
      att = att * sc(O_EXISTS + i) * sc(O_GRASPABLE + i);
      float settle_dn = SETTLE_DN * sc(SPHERE_DN + i);
      float tx = -go.x;
      float ty = -go.y;
      float off_x = tx + (ao.x - tx) * ONE_MINUS_SETTLE;
      float off_y = ty + (ao.y - ty) * ONE_MINUS_SETTLE;
      float canon_z = 0.006f - go.z;
      float sup_settle = support_z(sc, st.obj_pos[i].x, st.obj_pos[i].y);
      bool resting_now = st.obj_pos[i].z <= sup_settle + sc(O_HALF_H + i) + 1e-4f;
      float settle_up = SETTLE * (1.0f - b2f(resting_now));
      float off_z = ao.z < canon_z ? ao.z + (canon_z - ao.z) * settle_up
                                   : ao.z + (canon_z - ao.z) * settle_dn;
      ao = sel(att > 0.0f, V3{off_x, off_y, off_z}, ao);
      attached[i] = att;
      attach_off[i] = ao;
      unanchored[i] = una;
    }

    // --- free-object dynamics ---
    V3* pos = ob.pos;
    V3* vel = ob.vel;
    bool pinned_anchor[MAX_OBJ], free_old[MAX_OBJ];
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      bool pa = (sc(O_ANCHORED + i) > 0.0f) && (unanchored[i] == 0.0f);
      pinned_anchor[i] = pa;
      bool planar = sc.b(O_PLANAR + i);
      V3 v3 = st.obj_vel[i];
      float vz = v3.z - G_DT * b2f(!planar);
      vz = vz * (1.0f - b2f(planar));
      v3 = {v3.x, v3.y, vz};
      v3 = sel(planar, v3 * sc(VISC + i), v3);
      v3 = sel(pa, V3{0.0f * v3.x, 0.0f * v3.y, 0.0f * v3.z}, v3);
      float ej = sgn(st.obj_pos[i].x + sc(O_GRASP_OFF + 3 * i) - hand0.x);
      ej = ej == 0.0f ? -1.0f : ej;
      float vx_sq = squeezed_out[i] ? ej * mx(fabsf(v3.x), 0.2f) : v3.x;
      v3 = {vx_sq, v3.y, v3.z};
      bool ex = sc(O_EXISTS + i) > 0.0f;
      v3 = v3 * b2f(ex);
      pos[i] = sel(ex, st.obj_pos[i] + v3 * dt, st.obj_pos[i]);
      vel[i] = v3;
      free_old[i] = (st.attached[i] == 0.0f) && (sc(O_EXISTS + i) > 0.0f) && !pa;
    }

    // --- finger-pad pushing ---
    V3 kin[2];
    pad_centers(hand0, st.gripper, kin[0], kin[1]);
    bool pad_side_hit[2][MAX_OBJ];
    MW_UNROLL for (int side = 0; side < 2; ++side) {
      V3 kc = kin[side];
      MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
        V3 p = pos[i], v3 = vel[i];
        float radius = sc(O_RADIUS + i);
        V3 d = p - kc;
        V3 pen_box = {0.015f + sc(O_HALF_X + i) - fabsf(d.x),
                      0.0045f + radius - fabsf(d.y),
                      0.045f + sc(O_HALF_H + i) - fabsf(d.z)};
        bool hit_box = pen_box.x > 0.0f && pen_box.y > 0.0f && pen_box.z > 0.0f;
        AxisHit ah = axis_hit(d, pen_box, hit_box);
        V3 n_box = axis_dir(ah.k, ah.sgn);
        Push sph = sphere_box_pushout(p, radius, kc, V3{0.015f, 0.0045f, 0.045f});
        bool is_sph = sc.b(IS_SPHERE + i);
        V3 n = sel(is_sph, sph.n, n_box);
        float depth = is_sph ? sph.pen : ah.mag;
        bool hit = depth > 0.0f;
        float frac = is_sph ? 0.3f : 1.0f;
        p = p + n * (frac * depth);
        float v_rel_n = dot(v3 - hand_vel, n);
        v3 = sel(hit && (v_rel_n < 0.0f), v3 - n * v_rel_n, v3);
        float hand_n = dot(hand_vel, n);
        float ball_n = dot(v3, n);
        float boost = (hit && is_sph && (hand_n > 0.0f) && (ball_n < 1.3f * hand_n))
                          ? 1.3f * hand_n - ball_n : 0.0f;
        v3 = v3 + n * boost;
        V3 dv = hand_vel - v3;
        V3 dv_t = dv - n * dot(dv, n);
        float blend_eff = (!is_sph && (fabsf(n.z) > 0.7f)) ? 0.8f : sc(BLEND + i);
        v3 = v3 + dv_t * (hit ? blend_eff : 0.0f);
        bool side_hit = hit && (fabsf(n.z) < 0.7f);
        pos[i] = sel(free_old[i], p, pos[i]);
        vel[i] = sel(free_old[i], v3, vel[i]);
        if (i == 0) pad_depth0[side] = depth * sc(O_EXISTS + i);
        pad_side_hit[side][i] = side_hit && (sc(O_EXISTS + i) > 0.0f);
      }
    }

    // --- object-object contact ---
    V3 delta01 = pos[0] - pos[1];
    V3 hs_oo = {sc(O_OO_HALF_X) + sc(O_OO_HALF_X + 1), sc(O_RADIUS) + sc(O_RADIUS + 1),
                sc(O_HALF_H) + sc(O_HALF_H + 1)};
    V3 pen_ax = {hs_oo.x - fabsf(delta01.x), hs_oo.y - fabsf(delta01.y),
                 hs_oo.z - fabsf(delta01.z)};
    bool hit_oo = pen_ax.x > 0.0f && pen_ax.y > 0.0f && pen_ax.z > 0.0f;
    AxisHit oo = axis_hit(delta01, pen_ax, hit_oo);
    V3 n01 = axis_dir(oo.k, oo.sgn);
    float pen01 = oo.mag;
    bool both = (sc(O_EXISTS) > 0.0f) && (sc(O_EXISTS + 1) > 0.0f) &&
                (sc(LINK_ENABLE) == 0.0f);
    bool beyond_range[MAX_OBJ], mobile[MAX_OBJ];
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      float v_abs = 0.0f;
      float pk[2] = {pos[i].x, pos[i].y};
      MW_UNROLL for (int k = 0; k < 2; ++k) {
        float viol = mn(pk[k] - sc(O_XY_LO + 2 * i + k), 0.0f) +
                     mx(pk[k] - sc(O_XY_HI + 2 * i + k), 0.0f);
        v_abs = v_abs + fabsf(viol);
      }
      beyond_range[i] = (sc(O_XY_LIMITED + i) > 0.0f) && (v_abs > 1e-9f);
    }
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i)
      mobile[i] = (st.attached[i] == 0.0f) && !pinned_anchor[i] &&
                  (sc(O_EXISTS + i) > 0.0f) && !beyond_range[i];
    float w_tot = mx(b2f(mobile[0]) + b2f(mobile[1]) * 1.0f, 1.0f);
    float w0 = b2f(mobile[0]) / w_tot, w1 = b2f(mobile[1]) / w_tot;
    bool active01 = both && (pen01 > 0.0f);
    float pen_act = active01 ? pen01 : 0.0f;
    pos[0] = pos[0] + n01 * (pen_act * w0);
    pos[1] = pos[1] - n01 * (pen_act * w1);
    float v_n01 = dot(vel[0] - vel[1], n01);
    bool approaching = v_n01 < 0.0f;
    float vn_act = (active01 && approaching) ? v_n01 : 0.0f;
    vel[0] = vel[0] - n01 * (vn_act * w0);
    vel[1] = vel[1] + n01 * (vn_act * w1);
    bool drag_on = active01 && ((st.attached[0] > 0.0f) || (st.attached[1] > 0.0f));
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 dv_oo = hand_vel - vel[i];
      V3 dv_oo_t = dv_oo - n01 * dot(dv_oo, n01);
      float take = b2f(mobile[i] && (st.attached[i] == 0.0f)) * (drag_on ? 0.8f : 0.0f);
      vel[i] = vel[i] + dv_oo_t * take;
    }

    // --- static boxes ---
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 corr = box_contacts(sc, bpos, pos[i], sc(O_RADIUS + i));
      pos[i] = pos[i] + corr * b2f(free_old[i]);
      V3 corr_n = safe_normalize(corr);
      float v_into = mn(dot(vel[i], corr_n), 0.0f);
      bool hit_box = (norm3(corr) > 1e-9f) && free_old[i];
      vel[i] = sel(hit_box, vel[i] - corr_n * v_into, vel[i]);
    }

    // --- ground / pit support ---
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 p = pos[i], v3 = vel[i];
      float half_h = sc(O_HALF_H + i);
      float sz = support_z(sc, p.x, p.y);
      bool below = p.z - half_h < sz;
      p = {p.x, p.y, p.z + (below ? sz + half_h - p.z : 0.0f)};
      float vz_new = (below && (v3.z < 0.0f)) ? 0.0f : v3.z;
      bool no_imp = sc.b(IS_SPHERE + i) || (sc(O_XY_LIMITED + i) > 0.0f);
      float absorbed = (below && (v3.z < 0.0f) && !no_imp) ? -v3.z : 0.0f;
      float speed = norm2(v3.x, v3.y);
      float dec = sc(FRIC + i) * (G_DT + absorbed);
      float scl = speed > 1e-9f ? mx(speed - dec, 0.0f) / mx(speed, 1e-9f) : 0.0f;
      float xy_scale = below ? scl : 1.0f;
      v3 = {v3.x * xy_scale, v3.y * xy_scale, vz_new};
      pos[i] = sel(free_old[i], p, pos[i]);
      vel[i] = sel(free_old[i], v3, vel[i]);
    }

    // --- planar pinning ---
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      float z_pin = support_z(sc, pos[i].x, pos[i].y) + sc(O_HALF_H + i);
      bool pin = sc.b(O_PLANAR + i) && free_old[i];
      pos[i].z = pin ? z_pin : pos[i].z;
      vel[i].z = pin ? 0.0f : vel[i].z;
    }

    // --- limited slide joints ---
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      float lim_on = sc(O_XY_LIMITED + i) * b2f(free_old[i]);
      bool side_held = pad_side_hit[0][i] || pad_side_hit[1][i];
      float comp_v[2] = {vel[i].x, vel[i].y};
      float pk[2] = {pos[i].x, pos[i].y};
      MW_UNROLL for (int k = 0; k < 2; ++k) {
        float viol = mn(pk[k] - sc(O_XY_LO + 2 * i + k), 0.0f) +
                     mx(pk[k] - sc(O_XY_HI + 2 * i + k), 0.0f);
        float outside = lim_on * b2f(fabsf(viol) > 0.0f);
        float comp = comp_v[k];
        comp = comp - K_SLIDE_LIM * viol * dt * lim_on * (1.0f - b2f(side_held));
        comp = comp * (1.0f - outside * D_SLIDE_DECAY);
        comp_v[k] = comp;
      }
      vel[i] = {comp_v[0], comp_v[1], vel[i].z};
    }

    // --- jam back-reaction ---
    V3 jam_corr = {0.0f, 0.0f, 0.0f};
    MW_UNROLL for (int side = 0; side < 2; ++side) {
      MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
        V3 d = kin[side] - pos[i];
        V3 pen = {0.015f + sc(O_HALF_X + i) - fabsf(d.x),
                  0.0045f + sc(O_RADIUS + i) - fabsf(d.y),
                  0.045f + sc(O_HALF_H + i) - fabsf(d.z)};
        bool hit = pen.x > 0.0f && pen.y > 0.0f && pen.z > 0.0f &&
                   (sc(O_EXISTS + i) > 0.0f) && (sc(O_GRASPABLE + i) == 0.0f) &&
                   (st.attached[i] == 0.0f) && (sc(O_TYPE + i) != 2.0f);
        jam_corr = jam_corr + axis_corr(axis_hit(d, pen, hit));
      }
    }
    float jc_n = norm3(jam_corr);
    float move_h = norm3(new_hand - hand0);
    jam_corr = jam_corr * mn(1.0f, (move_h + 0.0005f) / mx(jc_n, 1e-9f));
    new_hand = new_hand + jam_corr;
    hand_vel = {(new_hand.x - hand0.x) / dt, (new_hand.y - hand0.y) / dt,
                (new_hand.z - hand0.z) / dt};

    // --- attached objects ride the hand ---
    V3 att_pos[MAX_OBJ];
    float att_z[MAX_OBJ];
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      att_pos[i] = new_hand + attach_off[i];
      float sup = support_z(sc, att_pos[i].x, att_pos[i].y);
      att_z[i] = mx(att_pos[i].z, sup + sc(O_HALF_H + i));
    }
    V3 tool_prev = st.obj_pos[0] + qrot(st.obj_quat[0], sc.v3(O_TOOL_OFF));
    V3 handle_prev = st.obj_pos[1] + sc.v3(LINK_HANDLE_OFF);
    bool linked_prev = (sc(LINK_ENABLE) > 0.0f) && (tool_prev.x >= handle_prev.x) &&
                       (fabsf(tool_prev.y - handle_prev.y) <= 0.045f) &&
                       (fabsf(tool_prev.z - handle_prev.z) <= 0.065f);
    att_z[0] = att_z[0] + (linked_prev ? mx(att_z[0], handle_prev.z - 0.04f) - att_z[0]
                                       : 0.0f);
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      bool pinned = (attached[i] > 0.0f) && (att_pos[i].z < att_z[i] - 1e-9f);
      attach_off[i].z = pinned ? att_z[i] - new_hand.z : attach_off[i].z;
      att_pos[i].z = att_z[i];
    }
    // climb over shallow walls
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      float r = sc(O_RADIUS + i);
      float climb = 0.0f;
      MW_UNROLL for (int s = 0; s < MAX_STATIC; ++s) {
        V3 bs = sc.v3(S_SIZE + 3 * s);
        Push pu = sphere_box_pushout(att_pos[i], r, bpos[s], bs);
        float pen_up = (bpos[s].z + bs.z + r) - att_pos[i].z;
        bool lateral = fabsf(pu.n.z) < 0.5f;
        bool ok = (sc(S_EXISTS + s) > 0.0f) && lateral && (pu.pen > 1e-6f) &&
                  (pen_up > 0.0f) && (pen_up < 0.045f);
        float cv = ok ? mn(pen_up, 0.0015f) : 0.0f;
        climb = s == 0 ? cv : mx(climb, cv);
      }
      climb = climb * attached[i];
      att_pos[i].z = att_pos[i].z + climb;
      attach_off[i].z = attach_off[i].z + climb;
    }
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      V3 corr_att = box_contacts(sc, bpos, att_pos[i], sc(O_RADIUS + i));
      corr_att = corr_att * b2f(attached[i] > 0.0f);
      att_pos[i] = att_pos[i] + corr_att;
      new_hand = new_hand + corr_att;
    }
    // attached-tool chain jam
    float jam_hx = 0.0f, jam_hy = 0.0f;
    MW_UNROLL for (int c = 0; c < 2; ++c) {
      int a = c, b = 1 - c;
      V3 dj = att_pos[a] - pos[b];
      V3 pen = {hs_oo.x - fabsf(dj.x), hs_oo.y - fabsf(dj.y), hs_oo.z - fabsf(dj.z)};
      bool hit_j = pen.x > 0.0f && pen.y > 0.0f && pen.z > 0.0f &&
                   (attached[a] > 0.0f) && beyond_range[b] &&
                   (sc(O_EXISTS + a) > 0.0f) && (sc(O_EXISTS + b) > 0.0f) &&
                   (sc(LINK_ENABLE) == 0.0f);
      AxisHit h = axis_hit(dj, pen, hit_j);
      jam_hx = jam_hx + (h.k.p0 ? h.mag * h.sgn : 0.0f);
      jam_hy = jam_hy + (h.k.p1 ? h.mag * h.sgn : 0.0f);
    }
    V3 jam_h3 = {jam_hx, jam_hy, 0.0f};
    float jam_n = norm3(jam_h3);
    V3 jam_dir = jam_h3 * (1.0f / mx(jam_n, 1e-9f));
    float proj_slip = 0.0f;
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i)
      proj_slip = proj_slip + b2f(attached[i] > 0.0f) * dot(attach_off[i], jam_dir);
    float slip_g = clip(0.035f - proj_slip, 0.0f, jam_n);
    V3 slip_vec = jam_dir * slip_g;
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      bool att = attached[i] > 0.0f;
      attach_off[i] = sel(att, attach_off[i] + slip_vec, attach_off[i]);
      att_pos[i] = sel(att, att_pos[i] + jam_h3, att_pos[i]);
    }
    new_hand = new_hand + (jam_h3 - slip_vec);
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      bool att = attached[i] > 0.0f;
      pos[i] = sel(att, att_pos[i], pos[i]);
      vel[i] = sel(att, hand_vel, vel[i]);
    }

    // --- rotational dynamics ---
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      float sz_u = support_z(sc, pos[i].x, pos[i].y);
      bool on_ground = (pos[i].z - sc(O_HALF_H + i)) <= (sz_u + 1e-4f);
      bool is_sph = sc.b(IS_SPHERE + i);
      bool free_rot = (attached[i] == 0.0f) && (sc(O_EXISTS + i) > 0.0f) && !pinned_anchor[i];
      V3 om = st.obj_angvel[i];
      float inv_r = 1.0f / mx(sc(O_RADIUS + i), 1e-6f);
      V3 roll_w = {-vel[i].y * inv_r, vel[i].x * inv_r, 0.0f * vel[i].z};
      om = sel(is_sph && on_ground && free_rot, roll_w, om);
      om = sel(!is_sph && on_ground && free_rot, om * OMEGA_DECAY, om);
      bool keep = free_rot && (sc(O_EXISTS + i) > 0.0f);
      om = om * b2f(keep);
      Q4 q = qintegrate(st.obj_quat[i], om, dt);
      Q4 twist = {q.w, 0.0f * q.x, 0.0f * q.y, q.z};
      float tn = sqrtf(mx(dot4(twist, twist), 1e-24f));
      Q4 ident = {1.0f, 0.0f * q.x, 0.0f * q.y, 0.0f * q.z};
      twist = sel(tn > 0.05f, Q4{twist.w / tn, twist.x / tn, twist.y / tn, twist.z / tn},
                  ident);
      Q4 righted = qnlerp(q, twist, ALPHA_R);
      q = sel(!is_sph && on_ground && free_rot, righted, q);
      float droop_on = sc(LINK_ENABLE) > 0.0f ? (linked_prev ? 1.0f : 0.0f) : 1.0f;
      float theta_eq = sc(O_DROOP + i) * droop_on;
      float half = theta_eq / 2.0f;
      Q4 q_droop = {cosf(half), 0.0f * half, sinf(half), 0.0f * half};
      Q4 drooped = qnlerp(q, q_droop, ALPHA_D);
      q = sel(attached[i] > 0.0f, drooped, q);
      ob.quat[i] = q;
      omega_out[i] = om;
    }

    // --- tool link ---
    V3 tool_pt = pos[0] + qrot(ob.quat[0], sc.v3(O_TOOL_OFF));
    V3 handle_pt = pos[1] + sc.v3(LINK_HANDLE_OFF);
    bool linked = (sc(LINK_ENABLE) > 0.0f) && (tool_pt.x >= handle_pt.x) &&
                  (fabsf(tool_pt.y - handle_pt.y) <= 0.040f) &&
                  (fabsf(tool_pt.z - handle_pt.z) <= 0.060f);
    float dy_link = tool_pt.y - handle_pt.y;
    V3 corr_link = {mn(tool_pt.x - handle_pt.x, 0.0f), dy_link - clip(dy_link, -0.03f, 0.03f),
                    0.0f * dy_link};
    float lk = linked ? 1.0f : 0.0f;
    pos[1] = pos[1] + corr_link * lk;
  } else {
    MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
      ob.pos[i] = st.obj_pos[i];
      ob.vel[i] = st.obj_vel[i];
      ob.quat[i] = st.obj_quat[i];
      omega_out[i] = st.obj_angvel[i];
      attached[i] = st.attached[i];
      attach_off[i] = st.attach_off[i];
      unanchored[i] = st.unanchored[i];
    }
  }

  float joint_q_out[MAX_JOINT], joint_v_out[MAX_JOINT];
  float hooked[MAX_JOINT], hook_off[MAX_JOINT];
  V3 hook_hoff[MAX_JOINT];
  if constexpr (WITH_JOINTS) {
    // --- fixture free dynamics ---
    JointCtx jc[MAX_JOINT];
    float q_free[MAX_JOINT];
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      V3 axis = sc.v3(J_AXIS + 3 * j);
      float qj = st.joint_q[j], qvj = st.joint_v[j];
      V3 com_arm = qrot(axquat(axis, qj), sc.v3(J_COM + 3 * j));
      V3 hinge_d = cross(axis, com_arm);
      float dcom_dq_z = sc.b(IS_HINGE + j) ? hinge_d.z : axis.z;
      float grav_q = -sc(J_MASS + j) * GRAVITY * dcom_dq_z;
      float f_ext = grav_q + sc(J_BIAS + j) - sc(J_STIFFNESS + j) * (qj - sc(J_SPRINGREF + j));
      float M_j = mx(sc(J_INERTIA + j), 1e-6f);
      float c_j = sc(J_DAMPING + j);
      float decay = sc(J_DECAY + j);
      qvj = c_j > 1e-9f ? qvj * decay + (f_ext / mx(c_j, 1e-9f)) * (1.0f - decay)
                        : qvj + (f_ext / M_j) * dt;
      q_free[j] = qj + qvj * dt;
    }
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      JointCtx& c = jc[j];
      c.handle = handle_pos(sc, j, fixture, q_free[j]);
      c.motion = motion_dir(sc, j, q_free[j]);
      Q4 q_rot_free = axquat(sc.v3(J_AXIS + 3 * j), q_free[j]);
      c.press_pt_off = qrot(q_rot_free, sc.v3(J_PRESS_OFF + 3 * j));
      c.press_fd = qrot(q_rot_free, sc.v3(J_FACE_DIR + 3 * j));
      c.lever = sc(LEVER + j);
      c.handle_radius = sc(J_HANDLE_RADIUS + j);
      c.face_radius = sc(J_FACE_RADIUS + j);
      c.range_lo = sc(J_RANGE + 2 * j);
      c.range_hi = sc(J_RANGE + 2 * j + 1);
      c.q_free = q_free[j];
      c.exists = sc(J_EXISTS + j);
      c.has_bar = sc.b(HAS_BAR + j);
      c.is_hinge = sc.b(IS_HINGE + j);
    }

    // --- hook engage / release ---
    V3 tcp_mid = {new_hand.x, new_hand.y, new_hand.z + TCP_MID_Z};
    V3 gap_w = target - new_hand;
    bool in_claw_j[MAX_JOINT];
    float q_inv_j[MAX_JOINT], gap_perp_j[MAX_JOINT];
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      V3 axis = sc.v3(J_AXIS + 3 * j);
      V3 rel_h = c.handle - new_hand;
      float d_xy = norm2(rel_h.x, rel_h.y);
      float d_z = rel_h.z;
      bool in_claw = (d_xy < 0.055f) && (d_z > -0.06f) && (d_z < 0.10f);
      float q_inv = fixture_inverse(sc, j, fixture, tcp_mid);
      float dq_cap = st.joint_q[j] - q_inv;
      dq_cap = c.is_hinge ? wrap_pi(dq_cap) : dq_cap;
      V3 gp = gap_w - c.motion * dot(gap_w, c.motion);
      float gap_perp_n = norm3(gp);
      bool hook_now = (sc(J_HOOKABLE + j) > 0.0f) && in_claw &&
                      (fabsf(dq_cap) <= sc(J_OFF_CAP + j)) && (effort > 0.0f) &&
                      (gripper < 0.9f) && (gap_perp_n < HOOK_SLIP_ENGAGE);
      bool newly_hooked = hook_now && (st.hooked[j] == 0.0f);
      float ho = newly_hooked ? dq_cap : st.hook_off[j];
      float hk = hook_now ? 1.0f : st.hooked[j];
      V3 off_local_now = qrot(axquat(axis, -st.joint_q[j]), new_hand - c.handle);
      off_local_now = sel(c.is_hinge, off_local_now, new_hand - c.handle);
      V3 hh = sel(newly_hooked, off_local_now, st.hook_hoff[j]);
      float vert = fabsf(motion_dir(sc, j, st.joint_q[j]).z);
      float wedge = ((effort > 0.0f) && (hk > 0.0f)) ? WEDGE_A * vert : 0.0f;
      ho = ho * (1.0f - wedge);
      bool at_stop = (st.joint_q[j] <= c.range_lo + 1e-6f) ||
                     (st.joint_q[j] >= c.range_hi - 1e-6f);
      bool slip = (gap_perp_n > HOOK_SLIP) || (at_stop && (norm3(gap_w) > HOOK_SLIP_2));
      bool collar = c.has_bar && (fabsf(sc(J_FACE_DIR + 3 * j + 2)) > 0.9f) &&
                    (c.face_radius >= 0.06f);
      slip = slip && !collar;
      bool unhook = (effort <= 0.0f) || (d_xy > 0.12f) || (d_z < -0.15f) || (d_z > 0.2f) || slip;
      hk = (unhook ? 0.0f : hk) * c.exists;
      hooked[j] = hk;
      hook_off[j] = ho;
      hook_hoff[j] = hh;
      in_claw_j[j] = in_claw;
      q_inv_j[j] = q_inv;
      gap_perp_j[j] = gap_perp_n;
    }

    // --- press contacts ---
    V3 knuckle = {new_hand.x, new_hand.y, new_hand.z + 0.105f};
    V3 knuckle_prev = {hand0.x, hand0.y, hand0.z + 0.105f};
    V3 left_prev, right_prev, left_press, right_press;
    pad_centers(hand0, st.gripper, left_prev, right_prev);
    pad_centers(new_hand, gripper, left_press, right_press);
    float pad_gap = gripper * GRIPPER_FULL_OPEN - PAD_GAP_INSET;
    float tip_active = clip((0.049f - pad_gap) / 0.02f, 0.0f, 1.0f);
    const V3 KNUCKLE_HALF = {0.022f, 0.040f, 0.053f};
    const V3 PLATE_HALF = {0.015f, 0.0045f, 0.045f};
    const V3 RAIL_HALF = {0.005f, 0.055f, 0.005f};
    const float R012_06 = (float)(0.6 * 0.012), R02_06 = (float)(0.6 * 0.02),
                R032_06 = (float)(0.6 * 0.032);

    bool soft_flag[MAX_JOINT][2];
    float jam_ex[MAX_JOINT];
    float dq_j[MAX_JOINT], q_new_j[MAX_JOINT], dq_hook_j[MAX_JOINT];
    float qv_hi_j[MAX_JOINT], qv_lo_j[MAX_JOINT];
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      V3 pt_face = c.handle + c.press_pt_off;
      PartAcc acc;
      acc.add(sphere_part(c, new_hand, hand0, 0.012f, R012_06, pt_face, c.lever, tip_active));
      Part ks = sphere_part(c, knuckle, knuckle_prev, 0.012f, R012_06, pt_face, c.lever, 1.0f);
      Part kb = box_part<false>(c, knuckle, knuckle_prev, KNUCKLE_HALF, true, 1.0f, nullptr);
      acc.add(c.has_bar ? kb : ks);
      DiscOut dl, dr;
      Part pl = box_part<true>(c, left_press, left_prev, PLATE_HALF, false, 1.0f, &dl);
      Part pr = box_part<true>(c, right_press, right_prev, PLATE_HALF, false, 1.0f, &dr);
      acc.add(pl);
      acc.add(dl.stop);
      acc.add(pr);
      acc.add(dr.stop);
      soft_flag[j][0] = dl.soft;
      soft_flag[j][1] = dr.soft;
      jam_ex[j] = mx(dl.jam_excess, dr.jam_excess);
      bool held_j = dl.hold || dr.hold;
      V3 rail = {new_hand.x, new_hand.y, new_hand.z + 0.095f};
      V3 rail_prev = {hand0.x, hand0.y, hand0.z + 0.095f};
      float rail_w = 1.0f - b2f(!c.has_bar && !c.is_hinge && (fabsf(c.motion.z) < 0.5f));
      acc.add(box_part<false>(c, rail, rail_prev, RAIL_HALF, false, rail_w, nullptr));
      if constexpr (WITH_OBJECTS) {
        MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
          V3 toff = sc.v3(O_TOOL_OFF + 3 * i);
          V3 tool_i = ob.pos[i] + qrot(ob.quat[i], toff);
          V3 tool_i_prev = st.obj_pos[i] + qrot(st.obj_quat[i], toff);
          acc.add(sphere_part(c, tool_i, tool_i_prev, 0.02f, R02_06, pt_face, c.lever,
                              sc(O_EXISTS + i)));
        }
      }
      // panel stations
      V3 pivot_w = fixture + sc.v3(J_ANCHOR + 3 * j);
      V3 panel_shift = c.motion * sc(J_PANEL_OFF + j);
      V3 span = (c.handle - pivot_w) + panel_shift;
      float span_n2 = dot(span, span);
      MW_UNROLL for (int k = 0; k < 2; ++k) {
        V3 center = k == 0 ? new_hand : knuckle;
        V3 cprev = k == 0 ? hand0 : knuckle_prev;
        float r_part = k == 0 ? 0.012f : 0.032f;
        float r06 = k == 0 ? R012_06 : R032_06;
        float fr = dot(center - pivot_w, span) / mx(span_n2, 1e-9f);
        fr = clip(fr, 0.3f, 0.97f);
        V3 station = pivot_w + span * fr;
        float st_lever = mx(c.lever * fr, 1e-6f);
        acc.add(sphere_part(c, center, cprev, r_part, r06, station, st_lever,
                            sc(J_PANEL + j)));
      }

      float dq = acc.dq_pos + acc.dq_neg;
      float hi = acc.hi, lo = acc.lo;
      bool grabbing = (sc(J_HOOKABLE + j) > 0.0f) && in_claw_j[j] && (effort > 0.0f) &&
                      ((sc(J_HOOK_CARRY + j) == 0.0f) || (gap_perp_j[j] < HOOK_SLIP_ENGAGE));
      dq = grabbing ? 0.0f : dq;
      hi = grabbing ? BIG_QV : hi;
      lo = grabbing ? -BIG_QV : lo;
      dq = clip(dq, NEG_DQ_CAP_STEP / c.lever, DQ_CAP_STEP / c.lever);
      float gap_n = fabsf(dot(target - new_hand, c.motion));
      float damp = sc(J_DAMPING + j);
      float dq_budget = (damp > 1e-9f ? WELD_K * gap_n * c.lever * dt / mx(damp, 1e-9f)
                                      : BIG_QV) + BUDGET_FLOOR;
      dq = clip(dq, -dq_budget, dq_budget);
      qv_hi_j[j] = hi;
      qv_lo_j[j] = lo;

      float q_target = q_inv_j[j] + hook_off[j];
      float dq_hook = q_target - st.joint_q[j];
      dq_hook = c.is_hinge ? wrap_pi(dq_hook) : dq_hook;
      dq_hook = sc(J_HOOK_CARRY + j) > 0.0f ? mx(dq_hook, 0.0f) : dq_hook;
      float hook_cap = mn(DQ_CAP_STEP, dq_budget);
      float q_hooked = st.joint_q[j] + clip(dq_hook, -hook_cap, hook_cap);
      float q_want = q_free[j] + dq;
      float q_new = hooked[j] > 0.0f ? q_hooked : q_want;
      q_new = clip(q_new, c.range_lo, c.range_hi);
      bool held = held_j && (hooked[j] == 0.0f);
      q_new = held ? mx(q_new, st.joint_q[j]) : q_new;
      dq_j[j] = dq;
      q_new_j[j] = q_new;
      dq_hook_j[j] = dq_hook;
    }

    // --- stop residual -> hand backoff ---
    V3 backoff = {0.0f, 0.0f, 0.0f};
    float residual_j[MAX_JOINT];
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      float q_free_clip = clip(q_free[j], c.range_lo, c.range_hi);
      float dq_realized = hooked[j] > 0.0f ? dq_j[j] : q_new_j[j] - q_free_clip;
      float residual = (dq_j[j] - dq_realized) * b2f(hooked[j] == 0.0f) * c.exists;
      residual = residual + ((dq_hook_j[j] - (q_new_j[j] - st.joint_q[j])) *
                             b2f(hooked[j] > 0.0f) * c.exists);
      residual_j[j] = residual;
      backoff = backoff - c.motion * (residual * c.lever);
    }
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) backoff = backoff - jc[j].motion * jam_ex[j];
    float bo_raw = norm3(backoff);
    float move_pre = norm3(new_hand - hand0);
    backoff = backoff * mn(1.0f, move_pre / mx(bo_raw, 1e-9f));
    new_hand = new_hand + backoff;
    // Coulomb pin against the bottomed-out fixture
    float bo_n = norm3(backoff);
    V3 bo_dir = backoff * (1.0f / mx(bo_n, 1e-9f));
    V3 dv_b = new_hand - hand0;
    float dvbn = dot(dv_b, bo_dir);
    V3 dv_bn = bo_dir * dvbn;
    V3 dv_bt = dv_b - dv_bn;
    float bt_mag = norm3(dv_bt);
    float bt_allow = mx(bt_mag - MU_HAND * bo_n, 0.0f);
    float scale_bt = bo_n > 1e-9f ? bt_allow / mx(bt_mag, 1e-9f) : 1.0f;
    bool pin_round = false;
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j)
      pin_round = pin_round || ((fabsf(residual_j[j]) > 1e-12f) && (sc(J_HOOKABLE + j) > 0.0f));
    scale_bt = pin_round ? 1.0f : scale_bt;
    // dome slip on vertically pressed disc faces
    bool any_disc = false;
    V3 lat_sum = {0.0f, 0.0f, 0.0f};
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      bool dl = (fabsf(residual_j[j]) > 1e-12f) && !c.has_bar &&
                (sc(J_HOOKABLE + j) == 0.0f) && (sc(J_PANEL + j) == 0.0f) &&
                (fabsf(c.motion.z) > 0.95f);
      any_disc = any_disc || dl;
      V3 lv = (c.handle + c.press_pt_off) - new_hand;
      lv = lv - c.motion * dot(lv, c.motion);
      lat_sum = lat_sum + lv * b2f(dl);
    }
    float lat_n = norm3(lat_sum);
    V3 lat_dir = lat_sum * (1.0f / mx(lat_n, 1e-9f));
    float toward = dot(dv_bt, lat_dir);
    V3 dv_bt_disc = lat_dir * clip(toward, 0.0f, lat_n);
    V3 dv_bt_eff = sel(any_disc, dv_bt_disc, dv_bt * scale_bt);
    new_hand = hand0 + dv_bn + dv_bt_eff;

    // --- rigid handle bars push the claw out ---
    V3 bar_corr = {0.0f, 0.0f, 0.0f};
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      V3 pt0 = c.handle + c.press_pt_off;
      float s_n = clip(dot(new_hand - pt0, c.press_fd), -c.face_radius, c.face_radius);
      V3 pt = pt0 + c.press_fd * s_n;
      V3 d3 = new_hand - pt;
      float dist = norm3(d3);
      float r_sum = c.handle_radius + HAND_TIP_R;
      float pen = mx(r_sum - dist, 0.0f);
      V3 n_dir = d3 * (1.0f / mx(dist, 1e-9f));
      V3 corr = n_dir * pen;
      corr = corr - c.motion * dot(corr, c.motion);
      bool wrap = (sc(J_HOOKABLE + j) > 0.0f) &&
                  ((hooked[j] > 0.0f) || (in_claw_j[j] && (effort > 0.0f)));
      bool act = c.has_bar && (c.exists > 0.0f) && !wrap;
      bar_corr = bar_corr + corr * b2f(act);
    }
    new_hand = new_hand + bar_corr;
    // rigid wrap lock + vertical-bar collar
    V3 lock = {0.0f, 0.0f, 0.0f};
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      Q4 q_rot_new = axquat(sc.v3(J_AXIS + 3 * j), q_new_j[j]);
      V3 off_w_new = sel(c.is_hinge, qrot(q_rot_new, hook_hoff[j]), hook_hoff[j]);
      V3 handle_new = handle_pos(sc, j, fixture, q_new_j[j]);
      V3 lc = (handle_new + off_w_new) - new_hand;
      lc = lc - c.motion * dot(lc, c.motion);
      bool collar = c.has_bar && (fabsf(sc(J_FACE_DIR + 3 * j + 2)) > 0.9f) &&
                    (c.face_radius >= 0.06f);
      V3 bar_w = qrot(q_rot_new, sc.v3(J_FACE_DIR + 3 * j));
      V3 off_tgt = target - handle_new;
      V3 off_lat = off_tgt - c.motion * dot(off_tgt, c.motion);
      off_lat = off_lat - bar_w * dot(off_lat, bar_w);
      float ln = norm3(off_lat);
      off_lat = off_lat * mn(1.0f, 0.030f / mx(ln, 1e-9f));
      V3 cc = (handle_new + off_lat) - new_hand;
      cc = cc - c.motion * dot(cc, c.motion);
      cc = cc - bar_w * dot(cc, bar_w);
      V3 bar_des = {target.x - TCPO_X, target.y - TCPO_Y, target.z - TCPO_Z - 0.012f};
      float err_bar = dot(bar_des - new_hand, bar_w);
      cc = cc + bar_w * (err_bar * SETTLE);
      lc = sel(collar, cc, lc);
      lock = lock + lc * b2f(hooked[j] > 0.0f);
    }
    new_hand = new_hand + lock;
    // knob-bar support: the claw parks on the rotating pointer bar's top
    bool knob_catch = false;
    float knob_z = -INFINITY;
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      const JointCtx& c = jc[j];
      bool knob_ok = c.is_hinge && (fabsf(sc(J_AXIS + 3 * j + 2)) > 0.9f) &&
                     (sc(J_HOOKABLE + j) == 0.0f) && (sc(J_PANEL + j) == 0.0f) &&
                     (c.handle_radius > 1e-6f) && (c.exists > 0.0f);
      V3 piv = fixture + sc.v3(J_ANCHOR + 3 * j);
      V3 hnew = handle_pos(sc, j, fixture, q_new_j[j]);
      float dx = hnew.x - piv.x, dy = hnew.y - piv.y;
      float dn = sqrtf(mx(dx * dx + dy * dy, 1e-18f));
      dx = dx / dn;
      dy = dy / dn;
      float top = piv.z + fabsf(sc(J_ARM + 3 * j + 2)) - 0.004f;
      V3 pk3[3];
      pad_centers(new_hand, gripper, pk3[0], pk3[1]);
      pk3[2] = new_hand;
      MW_UNROLL for (int k = 0; k < 3; ++k) {
        float rx = pk3[k].x - piv.x, ry = pk3[k].y - piv.y;
        float proj = rx * dx + ry * dy;
        float px = rx - proj * dx, py = ry - proj * dy;
        bool over = (fabsf(proj) <= 0.061f) && (sqrtf(mx(px * px + py * py, 1e-18f)) <= 0.025f);
        bool cth = knob_ok && over && (hand0.z >= top - 0.005f);
        knob_catch = knob_catch || cth;
        knob_z = mx(knob_z, cth ? top : -INFINITY);
      }
    }
    new_hand.z = knob_catch ? mx(new_hand.z, knob_z) : new_hand.z;

    // --- joint velocities with inelastic press bounds ---
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      float q_new = q_new_j[j];
      float qv = (q_new - st.joint_q[j]) / dt;
      float cand = clip(qv, qv_lo_j[j], qv_hi_j[j]);
      float qv_press = fabsf(cand) <= fabsf(qv) + 1e-9f ? cand : qv;
      qv = hooked[j] > 0.0f ? qv : qv_press;
      joint_q_out[j] = q_new * jc[j].exists;
      joint_v_out[j] = qv * jc[j].exists;
    }
    // finger yield under a soft plate press
    bool soft_any = false;
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      float gap_n_j = fabsf(dot(target - new_hand, jc[j].motion));
      soft_any = soft_any || ((soft_flag[j][0] || soft_flag[j][1]) && (gap_n_j > 0.06f));
    }
    float loaded_cap = mx(st.gripper - 0.0025f, 0.696f);
    gripper = soft_any ? mn(gripper, loaded_cap) : gripper;
  } else {
    MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
      joint_q_out[j] = st.joint_q[j];
      joint_v_out[j] = st.joint_v[j];
      hooked[j] = st.hooked[j];
      hook_off[j] = st.hook_off[j];
      hook_hoff[j] = st.hook_hoff[j];
    }
  }

  // --- table support under the claw with the Coulomb stick/slip pin ---
  float tbl = support_z(sc, new_hand.x, new_hand.y) - 0.010f;
  float blocked_z = mx(tbl - new_hand.z, 0.0f);
  float dv_sx = new_hand.x - hand0.x;
  float dv_sy = new_hand.y - hand0.y;
  float t_mag_s = sqrtf(mx(dv_sx * dv_sx + dv_sy * dv_sy, 1e-24f));
  float t_allow_s = mx(t_mag_s - MU_TABLE * blocked_z, 0.0f);
  float scale_s = blocked_z > 1e-9f ? t_allow_s / mx(t_mag_s, 1e-9f) : 1.0f;
  new_hand = {hand0.x + dv_sx * scale_s, hand0.y + dv_sy * scale_s, new_hand.z + blocked_z};
  hand_vel = {(new_hand.x - hand0.x) / dt, (new_hand.y - hand0.y) / dt,
              (new_hand.z - hand0.z) / dt};

  // --- pad forces ---
  float pad_f_l = 0.0f, pad_f_r = 0.0f;
  if constexpr (WITH_OBJECTS) {
    bool gripped0 = ((attached[0] > 0.0f) || can_grasp[0]) && (squeeze > 0.0f);
    pad_f_l = PAD_K * pad_depth0[0] + (gripped0 ? squeeze : 0.0f);
    pad_f_r = PAD_K * pad_depth0[1] + (gripped0 ? squeeze : 0.0f);
  }

  out.hand = new_hand;
  out.hand_vel = hand_vel;
  out.gripper = gripper;
  out.gripper_vel = gripper_vel;
  MW_UNROLL for (int i = 0; i < MAX_OBJ; ++i) {
    out.obj_pos[i] = ob.pos[i];
    out.obj_quat[i] = ob.quat[i];
    out.obj_vel[i] = ob.vel[i];
    out.obj_angvel[i] = omega_out[i];
    out.attached[i] = attached[i];
    out.attach_off[i] = attach_off[i];
    out.unanchored[i] = unanchored[i];
  }
  MW_UNROLL for (int j = 0; j < MAX_JOINT; ++j) {
    out.joint_q[j] = joint_q_out[j];
    out.joint_v[j] = joint_v_out[j];
    out.hooked[j] = hooked[j];
    out.hook_off[j] = hook_off[j];
    out.hook_hoff[j] = hook_hoff[j];
  }
  out.pad_force_l = pad_f_l;
  out.pad_force_r = pad_f_r;
  return out;
}

// FRAME_SKIP substeps of one env; the weld target and effort stay fixed.
template <bool WITH_OBJECTS, bool WITH_JOINTS, bool WITH_HAND_BOXES>
MW_HD State control_substeps(const Scene& sc, State s, V3 target, float effort) {
  for (int k = 0; k < FRAME_SKIP; ++k)
    s = substep<WITH_OBJECTS, WITH_JOINTS, WITH_HAND_BOXES>(sc, s, target, effort);
  return s;
}

}  // namespace mw

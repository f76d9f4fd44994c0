"""SO(3) / quaternion rotation kernels, JVP-safe.

JAX re-design of the Ceres rotation header (reference lineage:
``include/ceres/rotation.h`` — templated Jet-compatible conversions). Here
every function is a pure ``jnp`` function, differentiable with
``jax.jvp``/``jax.jacfwd``; small-angle branches are guarded with the
double-``where`` trick so derivatives stay finite at theta == 0.

Quaternion convention: Ceres order ``[w, x, y, z]`` (scalar first) unless the
function name says ``eigen`` (``[x, y, z, w]``, scalar last).

All functions operate on the last axis and broadcast over leading axes, so
they are `vmap`-free batched by construction.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "angle_axis_to_quaternion",
    "quaternion_to_angle_axis",
    "quaternion_product",
    "quaternion_conjugate",
    "unit_quaternion_rotate_point",
    "quaternion_rotate_point",
    "angle_axis_rotate_point",
    "quaternion_to_rotation_matrix",
    "rotation_matrix_to_quaternion",
    "angle_axis_to_rotation_matrix",
    "rotation_matrix_to_angle_axis",
    "eigen_quaternion_to_ceres",
    "ceres_quaternion_to_eigen",
]

_SMALL = 1e-12  # threshold on theta^2 below which Taylor branches engage


def _safe_sqrt(x2, use_taylor):
    """sqrt(x2) that has a finite derivative on the Taylor branch."""
    return jnp.sqrt(jnp.where(use_taylor, jnp.ones_like(x2), x2))


def angle_axis_to_quaternion(aa):
    """Angle-axis (3,) -> unit quaternion (4,), scalar-first.

    q = [cos(theta/2), sin(theta/2)/theta * aa].
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small = theta2 < _SMALL
    theta = _safe_sqrt(theta2, small)
    half = 0.5 * theta
    # sin(theta/2)/theta; Taylor: 1/2 - theta^2/48 + ...
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * aa], axis=-1)


def quaternion_to_angle_axis(q):
    """Unit quaternion (4,) scalar-first -> angle-axis (3,)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    sin2 = jnp.sum(xyz * xyz, axis=-1, keepdims=True)
    small = sin2 < _SMALL
    sin_theta = _safe_sqrt(sin2, small)
    # atan2 handles w<0 (angle > pi) correctly
    theta = 2.0 * jnp.arctan2(sin_theta, w)
    # k = theta / sin(theta/2); Taylor about sin->0 (theta->0, w->1): k -> 2/w
    k = jnp.where(small, 2.0 / jnp.where(small, w, jnp.ones_like(w)),
                  theta / sin_theta)
    return k * xyz


def quaternion_conjugate(q):
    return jnp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quaternion_product(a, b):
    """Hamilton product, scalar-first convention (z = a * b)."""
    aw, ax, ay, az = (a[..., 0], a[..., 1], a[..., 2], a[..., 3])
    bw, bx, by, bz = (b[..., 0], b[..., 1], b[..., 2], b[..., 3])
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def unit_quaternion_rotate_point(q, p):
    """Rotate point(s) p (…,3) by unit quaternion q (…,4), scalar-first.

    Uses the expanded 9-mult form rather than q*p*q^-1 (fewer flops, fuses
    well on the VPU).
    """
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    # t = 2 * cross(q.xyz, p)
    tx = 2.0 * (y * pz - z * py)
    ty = 2.0 * (z * px - x * pz)
    tz = 2.0 * (x * py - y * px)
    # p' = p + w*t + cross(q.xyz, t)
    rx = px + w * tx + (y * tz - z * ty)
    ry = py + w * ty + (z * tx - x * tz)
    rz = pz + w * tz + (x * ty - y * tx)
    return jnp.concatenate([rx, ry, rz], axis=-1)


def quaternion_rotate_point(q, p):
    """Rotate by a not-necessarily-unit quaternion (normalizes first)."""
    scale = 1.0 / jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
    return unit_quaternion_rotate_point(scale * q, p)


def angle_axis_rotate_point(aa, p):
    """Rodrigues rotation of p (…,3) by angle-axis aa (…,3), JVP-safe at 0."""
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small = theta2 < _SMALL
    theta = _safe_sqrt(theta2, small)
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    inv_theta = 1.0 / jnp.where(small, jnp.ones_like(theta), theta)
    w = aa * inv_theta  # unit axis (garbage on small branch; masked below)

    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    # cross(w, p)
    cx = wy * pz - wz * py
    cy = wz * px - wx * pz
    cz = wx * py - wy * px
    dot = wx * px + wy * py + wz * pz
    big = jnp.concatenate(
        [
            cos_t * px + sin_t * cx + (1.0 - cos_t) * dot * wx,
            cos_t * py + sin_t * cy + (1.0 - cos_t) * dot * wy,
            cos_t * pz + sin_t * cz + (1.0 - cos_t) * dot * wz,
        ],
        axis=-1,
    )
    # Small-angle: p + cross(aa, p)  (first-order Rodrigues)
    ax, ay, az = aa[..., 0:1], aa[..., 1:2], aa[..., 2:3]
    sx = ay * pz - az * py
    sy = az * px - ax * pz
    sz = ax * py - ay * px
    small_val = p + jnp.concatenate([sx, sy, sz], axis=-1)
    return jnp.where(small, small_val, big)


def quaternion_to_rotation_matrix(q):
    """Unit quaternion (…,4) scalar-first -> rotation matrix (…,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
    return r


def rotation_matrix_to_quaternion(r):
    """Rotation matrix (…,3,3) -> unit quaternion (…,4) scalar-first.

    Branchless Shepperd-style: compute all four candidate quaternions and
    select the one keyed by the largest diagonal combination (numerically
    stable and vmap/jit friendly — no data-dependent control flow).
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def _q(t, a, b, c, order):
        s = jnp.sqrt(jnp.maximum(t, 1e-30))
        half = 0.5 / s
        comps = {"t": 0.5 * s, "a": a * half, "b": b * half, "c": c * half}
        return jnp.stack([comps[k] for k in order], axis=-1)

    qw = _q(tw, m21 - m12, m02 - m20, m10 - m01, ("t", "a", "b", "c"))
    qx = _q(tx, m21 - m12, m01 + m10, m02 + m20, ("a", "t", "b", "c"))
    qy = _q(ty, m02 - m20, m01 + m10, m12 + m21, ("a", "b", "t", "c"))
    qz = _q(tz, m10 - m01, m20 + m02, m21 + m12, ("a", "b", "c", "t"))

    t_all = jnp.stack([tw, tx, ty, tz], axis=-1)
    idx = jnp.argmax(t_all, axis=-1)
    q_all = jnp.stack([qw, qx, qy, qz], axis=-2)  # (…,4 candidates,4)
    q = jnp.take_along_axis(q_all, idx[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    # canonical sign: w >= 0
    return jnp.where(q[..., :1] < 0, -q, q)


def angle_axis_to_rotation_matrix(aa):
    return quaternion_to_rotation_matrix(angle_axis_to_quaternion(aa))


def rotation_matrix_to_angle_axis(r):
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(r))


def eigen_quaternion_to_ceres(q_xyzw):
    """[x,y,z,w] -> [w,x,y,z]."""
    return jnp.concatenate([q_xyzw[..., 3:4], q_xyzw[..., :3]], axis=-1)


def ceres_quaternion_to_eigen(q_wxyz):
    """[w,x,y,z] -> [x,y,z,w]."""
    return jnp.concatenate([q_wxyz[..., 1:4], q_wxyz[..., :1]], axis=-1)

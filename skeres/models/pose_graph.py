"""Pose-graph (SLAM) residuals: SE(2) and SE(3) relative-pose constraints.

JAX counterpart of the reference lineage's pose-graph examples
(``examples/slam/pose_graph_2d/pose_graph_2d_error_term.h`` and
``examples/slam/pose_graph_3d/pose_graph_3d_error_term.h``): each edge
(a, b) with measured relative pose T_ab and square-root information L
contributes the residual L^T-weighted discrepancy between the predicted
relative pose of (x_a, x_b) and the measurement. Poses are single blocks —
SE(2) as (x, y, yaw) with a wraparound angle manifold, SE(3) as
(px, py, pz, qx, qy, qz, qw) with an Eigen-order quaternion manifold — so
whole graphs batch as two-slot residual arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from skeres.models.manifolds import (
    AngleManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    ProductManifold,
)
from skeres.ops import rotation as rot

__all__ = [
    "se2_manifold",
    "se3_manifold",
    "pose_graph_2d_error",
    "pose_graph_3d_error",
]


def se2_manifold() -> ProductManifold:
    """(x, y) Euclidean x yaw angle-with-wraparound."""
    return ProductManifold(EuclideanManifold(2), AngleManifold())


def se3_manifold() -> ProductManifold:
    """(px, py, pz) Euclidean x unit quaternion in Eigen [x,y,z,w] order."""
    return ProductManifold(EuclideanManifold(3), EigenQuaternionManifold())


def pose_graph_2d_error(params, data):
    """SE(2) relative-pose residual (3,).

    params = (pose_a (3,), pose_b (3,)) with pose = (x, y, yaw).
    data = dict(t_ab (2,), yaw_ab (), sqrt_information (3, 3)).

    r = L^T [ R(yaw_a)^T (p_b - p_a) - t_ab ;
              normalize(yaw_b - yaw_a - yaw_ab) ]
    """
    pose_a, pose_b = params
    p_a, yaw_a = pose_a[:2], pose_a[2]
    p_b, yaw_b = pose_b[:2], pose_b[2]

    c, s = jnp.cos(yaw_a), jnp.sin(yaw_a)
    # R(yaw_a)^T (p_b - p_a)
    d = p_b - p_a
    local = jnp.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1]])

    r_t = local - data["t_ab"]
    r_yaw = AngleManifold.normalize(yaw_b - yaw_a - data["yaw_ab"])
    r = jnp.concatenate([r_t, r_yaw[None]])
    return data["sqrt_information"] @ r


def pose_graph_3d_error(params, data):
    """SE(3) relative-pose residual (6,).

    params = (pose_a (7,), pose_b (7,)) with pose = (p (3,), q_xyzw (4,)).
    data = dict(t_ab (3,), q_ab (4,) xyzw, sqrt_information (6, 6)).

    r = L^T [ R(q_a)^T (p_b - p_a) - t_ab ;
              2 * vec(q_ab^{-1} * (q_a^{-1} q_b)) ]
    """
    pose_a, pose_b = params
    p_a, q_a = pose_a[:3], rot.eigen_quaternion_to_ceres(pose_a[3:7])
    p_b, q_b = pose_b[:3], rot.eigen_quaternion_to_ceres(pose_b[3:7])
    q_ab = rot.eigen_quaternion_to_ceres(data["q_ab"])

    q_a_inv = rot.quaternion_conjugate(q_a)
    # estimated relative rotation / translation in frame a
    q_ab_est = rot.quaternion_product(q_a_inv, q_b)
    t_ab_est = rot.unit_quaternion_rotate_point(q_a_inv, p_b - p_a)

    dq = rot.quaternion_product(rot.quaternion_conjugate(q_ab), q_ab_est)
    r = jnp.concatenate([t_ab_est - data["t_ab"], 2.0 * dq[1:4]])
    return data["sqrt_information"] @ r

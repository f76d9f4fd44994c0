"""Bundle-adjustment reprojection residuals.

JAX counterpart of the reference lineage's BAL cost functor
(``examples/snavely_reprojection_error.h``): the Snavely camera model from
the Bundle Adjustment in the Large dataset — 9-parameter camera
(angle-axis rotation (3), translation (3), focal length, k1, k2 radial
distortion), 3-parameter point, 2D pixel observation. Written as a pure
jnp function of (camera, point) so the evaluator vmaps it over all
observations and differentiates it with jvp.
"""

from __future__ import annotations

import jax.numpy as jnp

from skeres.ops import rotation as rot

__all__ = ["snavely_reprojection_error", "snavely_reprojection_error_fixed_k"]


def snavely_reprojection_error(params, observation):
    """params = (camera (9,), point (3,)); observation = (u, v) pixels.

    BAL convention: the camera looks down the -z axis, so the projection is
    p = -P / P.z with P the point in camera coordinates.
    """
    camera, point = params
    angle_axis = camera[0:3]
    translation = camera[3:6]
    focal = camera[6]
    k1 = camera[7]
    k2 = camera[8]

    p = rot.angle_axis_rotate_point(angle_axis, point) + translation
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]

    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (k1 + k2 * r2)

    predicted_x = focal * distortion * xp
    predicted_y = focal * distortion * yp
    return jnp.stack(
        [predicted_x - observation[0], predicted_y - observation[1]]
    )


def snavely_reprojection_error_fixed_k(params, observation):
    """Variant with intrinsics folded into the observation:
    observation = (u, v, focal, k1, k2); camera is 6-dof pose only."""
    camera, point = params
    p = rot.angle_axis_rotate_point(camera[0:3], point) + camera[3:6]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (observation[3] + observation[4] * r2)
    f = observation[2]
    return jnp.stack(
        [f * distortion * xp - observation[0], f * distortion * yp - observation[1]]
    )

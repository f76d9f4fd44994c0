"""BAL (Bundle Adjustment in the Large) dataset IO.

Counterpart of the reference lineage's BAL loader
(``examples/bal_problem.cc``): parses the BAL text format

    num_cameras num_points num_observations
    cam_idx point_idx u v                     (x num_observations)
    camera parameters, one per line           (x num_cameras * 9)
    point parameters, one per line            (x num_points * 3)

plus the reference's Normalize() / Perturb() preprocessing, and — because
this environment has no network to fetch grail.cs.washington.edu data — a
synthetic BAL-style problem generator with the same camera model, used by
tests and benchmarks when no real dataset is staged under ``data/``.

Parsing uses ``np.fromstring``-style bulk reads (one pass, no Python
per-line loop) so venice-scale files (~30M numbers) load in seconds; a
C++ loader in ``skeres/native`` (built at first use) is faster still.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

__all__ = ["BalProblem", "load_bal", "synthetic_bal", "build_bal_problem"]


@dataclasses.dataclass
class BalProblem:
    cameras: np.ndarray  # (num_cameras, 9) float64
    points: np.ndarray  # (num_points, 3) float64
    camera_index: np.ndarray  # (num_obs,) int32
    point_index: np.ndarray  # (num_obs,) int32
    observations: np.ndarray  # (num_obs, 2) float64

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]

    # -- reference BALProblem::Normalize ------------------------------------

    def normalize(self, median_distance: float = 100.0) -> None:
        """Center the reconstruction at the point-cloud median and rescale
        so the median absolute deviation is ``median_distance``."""
        from skeres.ops import rotation as rot
        import jax.numpy as jnp
        import jax

        median = np.median(self.points, axis=0)
        dev = np.sum(np.abs(self.points - median), axis=1)
        scale = median_distance / np.median(dev)

        self.points = scale * (self.points - median)

        # camera center c = -R' t  =>  t = -R c; transform c like a point
        aa = jnp.asarray(self.cameras[:, 0:3])
        t = jnp.asarray(self.cameras[:, 3:6])
        c = jax.vmap(lambda a, tt: -rot.angle_axis_rotate_point(-a, tt))(aa, t)
        c = scale * (np.asarray(c) - median)
        t_new = jax.vmap(lambda a, cc: -rot.angle_axis_rotate_point(a, cc))(
            aa, jnp.asarray(c)
        )
        self.cameras[:, 3:6] = np.asarray(t_new)

    # -- reference BALProblem::Perturb --------------------------------------

    def perturb(
        self,
        rotation_sigma: float = 0.0,
        translation_sigma: float = 0.0,
        point_sigma: float = 0.0,
        seed: int = 38401,
    ) -> None:
        rng = np.random.default_rng(seed)
        if point_sigma > 0:
            self.points += rng.normal(0, point_sigma, self.points.shape)
        if translation_sigma > 0:
            self.cameras[:, 3:6] += rng.normal(
                0, translation_sigma, (self.num_cameras, 3)
            )
        if rotation_sigma > 0:
            self.cameras[:, 0:3] += rng.normal(
                0, rotation_sigma, (self.num_cameras, 3)
            )


def load_bal(path: str) -> BalProblem:
    """Parse a BAL text file (supports .txt and .txt.bz2/.gz)."""
    if path.endswith(".bz2"):
        import bz2

        raw = bz2.open(path, "rt").read()
    elif path.endswith(".gz"):
        import gzip

        raw = gzip.open(path, "rt").read()
    else:
        # try the native fast loader first (mmap + SIMD-friendly scan)
        try:
            from skeres.native import bal_native

            return BalProblem(*bal_native.load(path))
        except Exception:
            raw = open(path, "rt").read()

    nums = np.array(raw.split(), dtype=np.float64)
    nc, npnt, nobs = int(nums[0]), int(nums[1]), int(nums[2])
    k = 3
    obs = nums[k : k + 4 * nobs].reshape(nobs, 4)
    k += 4 * nobs
    cameras = nums[k : k + 9 * nc].reshape(nc, 9)
    k += 9 * nc
    points = nums[k : k + 3 * npnt].reshape(npnt, 3)
    return BalProblem(
        cameras=np.ascontiguousarray(cameras),
        points=np.ascontiguousarray(points),
        camera_index=obs[:, 0].astype(np.int32),
        point_index=obs[:, 1].astype(np.int32),
        observations=np.ascontiguousarray(obs[:, 2:4]),
    )


def synthetic_bal(
    num_cameras: int = 16,
    num_points: int = 500,
    observations_per_point: int = 4,
    pixel_noise: float = 0.5,
    seed: int = 7,
    perturb_rotation: float = 0.03,
    perturb_translation: float = 0.2,
    perturb_point: float = 0.3,
) -> BalProblem:
    """Generate a BAL-style synthetic scene: cameras on a ring looking at a
    point cloud near the origin, ground-truth projections + pixel noise,
    then a perturbed initial estimate (so the solver has real work).

    Substitute for the un-downloadable grail.cs.washington.edu datasets;
    same structure and camera model as the reference's BAL problems.
    """
    rng = np.random.default_rng(seed)

    # ground-truth scene
    points = rng.normal(0.0, 2.0, size=(num_points, 3))
    radius = 12.0
    cameras = np.zeros((num_cameras, 9))
    from skeres.ops import rotation as rot
    import jax
    import jax.numpy as jnp

    # vectorized camera ring (venice scale is ~1.8k cameras; one device
    # call per camera would dominate)
    theta = 2.0 * np.pi * np.arange(num_cameras) / num_cameras
    c = np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), np.full_like(theta, 3.0)],
        axis=1,
    )
    # camera looks at the origin along its -z axis (BAL convention)
    z = c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    r_mat = np.stack([x, y, z], axis=1)  # (n, 3, 3) world -> camera
    aa = np.asarray(
        jax.vmap(rot.rotation_matrix_to_angle_axis)(jnp.asarray(r_mat))
    )
    t = -np.einsum("nij,nj->ni", r_mat, c)
    cameras[:, 0:3] = aa
    cameras[:, 3:6] = t
    cameras[:, 6] = 500.0 + rng.normal(0, 10, num_cameras)  # focal
    cameras[:, 7] = -1e-7
    cameras[:, 8] = 1e-13

    # observations: each point seen by a few consecutive cameras
    # (vectorized — venice-scale generation is ~1M points / ~5M obs)
    k = min(observations_per_point, num_cameras)
    start = rng.integers(0, num_cameras, size=num_points)
    cam_idx = (
        (start[:, None] + np.arange(k)[None, :]) % num_cameras
    ).reshape(-1).astype(np.int32)
    pt_idx = np.repeat(np.arange(num_points, dtype=np.int32), k)

    from skeres.models.reprojection import snavely_reprojection_error

    def project(cam, pnt):
        return snavely_reprojection_error((cam, pnt), jnp.zeros((2,)))

    proj = jax.vmap(project)(
        jnp.asarray(cameras[cam_idx]), jnp.asarray(points[pt_idx])
    )
    observations = np.asarray(proj) + rng.normal(
        0.0, pixel_noise, size=(len(cam_idx), 2)
    )

    prob = BalProblem(
        cameras=cameras,
        points=points.copy(),
        camera_index=cam_idx,
        point_index=pt_idx,
        observations=observations,
    )
    prob.perturb(
        rotation_sigma=perturb_rotation,
        translation_sigma=perturb_translation,
        point_sigma=perturb_point,
        seed=seed + 1,
    )
    return prob


def build_bal_problem(bal: BalProblem, loss=None, use_schur_ordering: bool = True):
    """Build a skeres Problem from a BalProblem (counterpart of the
    reference's ``bundle_adjuster.cc`` BuildProblem)."""
    from skeres.core.problem import Problem
    from skeres.models.reprojection import snavely_reprojection_error

    problem = Problem()
    cameras = problem.add_parameter_block_array(bal.cameras, name="cameras")
    points = problem.add_parameter_block_array(bal.points, name="points")
    if use_schur_ordering:
        problem.set_schur_elimination_group(points, 0)
        problem.set_schur_elimination_group(cameras, 1)

    problem.add_residual_blocks(
        snavely_reprojection_error,
        loss,
        [(cameras, bal.camera_index), (points, bal.point_index)],
        data=bal.observations,
        name="snavely",
    )
    return problem, cameras, points

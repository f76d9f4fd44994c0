"""Rotation kernel tests (counterpart of the reference lineage's
rotation_test: round-trips, near-zero-angle branches, derivative safety)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skeres.ops import rotation as rot

RNG = np.random.default_rng(0)


def random_angle_axis(n=64, scale=np.pi * 0.9):
    v = RNG.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    theta = RNG.uniform(1e-3, scale, size=(n, 1))
    return jnp.asarray(v * theta)


class TestQuaternionAngleAxis:
    def test_round_trip(self):
        aa = random_angle_axis()
        q = rot.angle_axis_to_quaternion(aa)
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-12)
        aa2 = rot.quaternion_to_angle_axis(q)
        np.testing.assert_allclose(aa, aa2, atol=1e-10)

    def test_zero_angle(self):
        aa = jnp.zeros((3,))
        q = rot.angle_axis_to_quaternion(aa)
        np.testing.assert_allclose(q, [1.0, 0, 0, 0], atol=1e-15)
        np.testing.assert_allclose(rot.quaternion_to_angle_axis(q), 0.0, atol=1e-15)

    def test_small_angle_branch_matches_large(self):
        # values just above/below the Taylor threshold agree
        for theta in [1e-7, 1e-6, 1e-5]:
            aa = jnp.array([theta, 0.0, 0.0])
            q = rot.angle_axis_to_quaternion(aa)
            expected = np.array(
                [np.cos(theta / 2), np.sin(theta / 2), 0.0, 0.0]
            )
            np.testing.assert_allclose(q, expected, atol=1e-14)

    def test_jacobian_finite_at_zero(self):
        j = jax.jacfwd(rot.angle_axis_to_quaternion)(jnp.zeros(3))
        assert np.all(np.isfinite(j))
        # d q / d aa at 0 = [0; I/2]
        np.testing.assert_allclose(j[0], 0.0, atol=1e-12)
        np.testing.assert_allclose(j[1:], 0.5 * np.eye(3), atol=1e-12)

    def test_angle_greater_than_pi(self):
        # quaternion with negative w => rotation angle > pi handled via atan2
        aa = jnp.array([0.0, 0.0, 0.9 * np.pi])
        q = rot.angle_axis_to_quaternion(aa)
        aa2 = rot.quaternion_to_angle_axis(-q)  # -q is the same rotation
        r1 = rot.angle_axis_to_rotation_matrix(aa)
        r2 = rot.angle_axis_to_rotation_matrix(aa2)
        np.testing.assert_allclose(r1, r2, atol=1e-9)


class TestRotatePoint:
    def test_matches_matrix(self):
        aa = random_angle_axis(32)
        p = jnp.asarray(RNG.normal(size=(32, 3)))
        r = rot.angle_axis_to_rotation_matrix(aa)
        expected = jnp.einsum("bij,bj->bi", r, p)
        np.testing.assert_allclose(rot.angle_axis_rotate_point(aa, p), expected, atol=1e-10)
        q = rot.angle_axis_to_quaternion(aa)
        np.testing.assert_allclose(
            rot.unit_quaternion_rotate_point(q, p), expected, atol=1e-10
        )
        np.testing.assert_allclose(
            rot.quaternion_rotate_point(3.7 * q, p), expected, atol=1e-10
        )

    def test_zero_rotation(self):
        p = jnp.asarray(RNG.normal(size=(5, 3)))
        np.testing.assert_allclose(
            rot.angle_axis_rotate_point(jnp.zeros((5, 3)), p), p, atol=1e-15
        )

    def test_jacobian_finite_at_zero_angle(self):
        p = jnp.array([1.0, 2.0, 3.0])
        j = jax.jacfwd(lambda a: rot.angle_axis_rotate_point(a, p))(jnp.zeros(3))
        assert np.all(np.isfinite(j))
        # d(R(aa) p)/d aa at aa=0 is -[p]_x
        skew = np.array([[0, 3, -2], [-3, 0, 1], [2, -1, 0]], dtype=float)
        np.testing.assert_allclose(j, skew, atol=1e-8)


class TestRotationMatrix:
    def test_quaternion_matrix_round_trip(self):
        aa = random_angle_axis(64)
        q = rot.angle_axis_to_quaternion(aa)
        m = rot.quaternion_to_rotation_matrix(q)
        # orthonormal, det 1
        np.testing.assert_allclose(
            jnp.einsum("bij,bkj->bik", m, m), np.broadcast_to(np.eye(3), (64, 3, 3)),
            atol=1e-12,
        )
        np.testing.assert_allclose(np.linalg.det(np.asarray(m)), 1.0, atol=1e-12)
        q2 = rot.rotation_matrix_to_quaternion(m)
        # same rotation up to sign; canonical w>=0
        qc = jnp.where(q[..., :1] < 0, -q, q)
        np.testing.assert_allclose(qc, q2, atol=1e-10)

    def test_all_shepperd_branches(self):
        # rotations by ~pi about each axis exercise each diagonal branch
        for axis in np.eye(3):
            aa = jnp.asarray(axis * (np.pi - 1e-3))
            m = rot.angle_axis_to_rotation_matrix(aa)
            aa2 = rot.rotation_matrix_to_angle_axis(m)
            m2 = rot.angle_axis_to_rotation_matrix(aa2)
            np.testing.assert_allclose(m, m2, atol=1e-9)

    def test_identity(self):
        q = rot.rotation_matrix_to_quaternion(jnp.eye(3))
        np.testing.assert_allclose(q, [1, 0, 0, 0], atol=1e-12)


def test_eigen_convention_round_trip():
    q = jnp.asarray(RNG.normal(size=(8, 4)))
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        rot.ceres_quaternion_to_eigen(rot.eigen_quaternion_to_ceres(q)), q
    )

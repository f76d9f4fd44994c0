"""Manifolds (local parameterizations) for constrained parameter blocks.

JAX re-design of the Ceres manifold layer (reference lineage:
``include/ceres/manifold.h`` / ``internal/ceres/manifold.cc``). The protocol
is the same four operations — ``plus``, ``plus_jacobian``, ``minus``,
``minus_jacobian`` — but every operation is a pure ``jnp`` function over a
*single* block that the evaluator ``vmap``s over whole batches of blocks;
there is no per-block virtual dispatch.

The solver never needs ``plus_jacobian`` on the hot path: tangent-space
Jacobians come from differentiating ``residual(plus(x, delta))`` at
``delta = 0`` with ``jax.jvp``, which is mathematically identical to the
reference's global-Jacobian × plus-Jacobian chain rule but fuses into one
forward pass. ``plus_jacobian`` is kept for the gradient checker and parity
tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from skeres.ops import rotation as rot

__all__ = [
    "Manifold",
    "EuclideanManifold",
    "SubsetManifold",
    "QuaternionManifold",
    "EigenQuaternionManifold",
    "SphereManifold",
    "LineManifold",
    "AngleManifold",
    "ProductManifold",
]

_SMALL = 1e-12


class Manifold:
    """Protocol: a smooth (sub)manifold with a local exp/log map."""

    ambient_size: int
    tangent_size: int

    def plus(self, x, delta):
        """x (+) delta: ambient (n,) x tangent (m,) -> ambient (n,)."""
        raise NotImplementedError

    def minus(self, y, x):
        """y (-) x: tangent (m,) such that plus(x, minus(y, x)) ~= y."""
        raise NotImplementedError

    def plus_jacobian(self, x):
        """d plus(x, delta) / d delta at delta = 0 -> (ambient, tangent)."""
        zero = jnp.zeros((self.tangent_size,), dtype=x.dtype)
        return jax.jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x):
        """d minus(y, x) / d y at y = x -> (tangent, ambient)."""
        return jax.jacfwd(lambda y: self.minus(y, x))(x)


class EuclideanManifold(Manifold):
    """R^n with plus = +."""

    def __init__(self, size: int):
        self.ambient_size = int(size)
        self.tangent_size = int(size)

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    def plus_jacobian(self, x):
        return jnp.eye(self.ambient_size, dtype=x.dtype)

    def minus_jacobian(self, x):
        return jnp.eye(self.ambient_size, dtype=x.dtype)


class SubsetManifold(Manifold):
    """Euclidean manifold with a subset of coordinates held constant."""

    def __init__(self, size: int, constant_indices):
        self.ambient_size = int(size)
        self.constant_indices = tuple(sorted(int(i) for i in constant_indices))
        free = [i for i in range(size) if i not in self.constant_indices]
        self.free_indices = tuple(free)
        self.tangent_size = len(free)
        import numpy as np

        m = np.zeros((size, self.tangent_size))
        for col, row in enumerate(free):
            m[row, col] = 1.0
        self._lift = m  # (ambient, tangent) 0/1 matrix

    def plus(self, x, delta):
        return x + jnp.asarray(self._lift, dtype=x.dtype) @ delta

    def minus(self, y, x):
        return jnp.asarray(self._lift.T, dtype=x.dtype) @ (y - x)

    def plus_jacobian(self, x):
        return jnp.asarray(self._lift, dtype=x.dtype)

    def minus_jacobian(self, x):
        return jnp.asarray(self._lift.T, dtype=x.dtype)


def _quat_exp(delta):
    """Tangent (3,) -> unit quaternion [w,x,y,z]; |delta| is the half-angle."""
    n2 = jnp.sum(delta * delta, axis=-1, keepdims=True)
    small = n2 < _SMALL
    n = jnp.sqrt(jnp.where(small, jnp.ones_like(n2), n2))
    k = jnp.where(small, 1.0 - n2 / 6.0, jnp.sin(n) / n)
    w = jnp.where(small, 1.0 - n2 / 2.0, jnp.cos(n))
    return jnp.concatenate([w, k * delta], axis=-1)


def _quat_log(q):
    """Unit quaternion [w,x,y,z] -> tangent (3,) (half-angle scaled axis)."""
    xyz = q[..., 1:]
    w = q[..., :1]
    s2 = jnp.sum(xyz * xyz, axis=-1, keepdims=True)
    small = s2 < _SMALL
    s = jnp.sqrt(jnp.where(small, jnp.ones_like(s2), s2))
    angle = jnp.arctan2(s, w)
    k = jnp.where(small, 1.0 / jnp.where(small, w, jnp.ones_like(w)), angle / s)
    return k * xyz


class QuaternionManifold(Manifold):
    """Unit quaternions, Ceres scalar-first [w,x,y,z] convention.

    plus(x, delta) = exp(delta) * x; minus(y, x) = log(y * conj(x)).
    """

    ambient_size = 4
    tangent_size = 3

    def plus(self, x, delta):
        return rot.quaternion_product(_quat_exp(delta), x)

    def minus(self, y, x):
        # no double-cover flip: exp(log(d)) == d exactly, so
        # plus(x, minus(y, x)) reproduces y bit-for-bit (matches the
        # reference's QuaternionManifold::Minus, which does not flip either)
        d = rot.quaternion_product(y, rot.quaternion_conjugate(x))
        return _quat_log(d)


class EigenQuaternionManifold(Manifold):
    """Unit quaternions in Eigen [x,y,z,w] storage order."""

    ambient_size = 4
    tangent_size = 3

    def plus(self, x, delta):
        q = rot.eigen_quaternion_to_ceres(x)
        out = rot.quaternion_product(_quat_exp(delta), q)
        return rot.ceres_quaternion_to_eigen(out)

    def minus(self, y, x):
        qy = rot.eigen_quaternion_to_ceres(y)
        qx = rot.eigen_quaternion_to_ceres(x)
        d = rot.quaternion_product(qy, rot.quaternion_conjugate(qx))
        return _quat_log(d)


def _householder(x):
    """Householder vector (v, beta) with (I - beta v v^T) x ~ mu * e_last.

    Trace-safe version of the reference's ComputeHouseholderVector
    (``internal/ceres/householder_vector.h`` in the Ceres lineage).
    """
    n = x.shape[-1]
    sigma = jnp.sum(x[..., :-1] * x[..., :-1], axis=-1)
    pivot = x[..., -1]
    mu = jnp.sqrt(pivot * pivot + sigma)
    degenerate = sigma < _SMALL

    v_pivot_neg = pivot - mu
    v_pivot_pos = -sigma / jnp.where(degenerate, jnp.ones_like(pivot), pivot + mu)
    v_pivot = jnp.where(pivot <= 0.0, v_pivot_neg, v_pivot_pos)
    v_pivot = jnp.where(degenerate, jnp.ones_like(v_pivot), v_pivot)

    beta = 2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot)
    beta = jnp.where(degenerate,
                     jnp.where(pivot >= 0.0, jnp.zeros_like(beta),
                               jnp.full_like(beta, 2.0)),
                     beta)
    # only the head is divided by v_pivot; the last entry stays 1
    safe_pivot = jnp.where(degenerate, jnp.ones_like(v_pivot), v_pivot)
    head = x[..., :-1] / safe_pivot[..., None]
    head = jnp.where(degenerate[..., None], jnp.zeros_like(head), head)
    v = jnp.concatenate([head, jnp.ones_like(pivot)[..., None]], axis=-1)
    return v, beta


def _apply_householder(v, beta, y):
    return y - beta[..., None] * v * jnp.sum(v * y, axis=-1, keepdims=True)


class SphereManifold(Manifold):
    """The (n-1)-sphere of radius ||x|| embedded in R^n (n >= 2).

    Re-design of the reference's SphereManifold: the tangent basis is built
    from the Householder reflection taking x to ||x|| e_n.
    """

    def __init__(self, size: int):
        assert size >= 2
        self.ambient_size = int(size)
        self.tangent_size = int(size) - 1

    def plus(self, x, delta):
        n2 = jnp.sum(delta * delta)
        small = n2 < _SMALL
        nd = jnp.sqrt(jnp.where(small, 1.0, n2))
        sinc = jnp.where(small, 1.0 - n2 / 6.0, jnp.sin(nd) / nd)
        w = jnp.where(small, 1.0 - n2 / 2.0, jnp.cos(nd))
        y = jnp.concatenate([sinc * delta, w[None]])
        v, beta = _householder(x)
        r = jnp.linalg.norm(x)
        return r * _apply_householder(v, beta, y)

    def minus(self, y, x):
        v, beta = _householder(x)
        hy = _apply_householder(v, beta, y) / jnp.linalg.norm(y)
        head, last = hy[:-1], hy[-1]
        hn2 = jnp.sum(head * head)
        small = hn2 < _SMALL
        hn = jnp.sqrt(jnp.where(small, 1.0, hn2))
        angle = jnp.arctan2(hn, last)
        k = jnp.where(small, 1.0 / jnp.where(small, last, 1.0), angle / hn)
        return k * head


class LineManifold(Manifold):
    """A line in R^n as (origin, direction): ambient 2n, tangent 2(n-1).

    Re-design of the reference lineage's LineManifold
    (``include/ceres/manifold.h``): the origin moves only within the
    hyperplane orthogonal to the direction (lifted through the Householder
    basis that maps the direction to ``||d|| e_n``), and the direction moves
    on the sphere exactly like SphereManifold.
    """

    def __init__(self, size: int):
        assert size >= 2
        self.line_dim = int(size)
        self.ambient_size = 2 * int(size)
        self.tangent_size = 2 * (int(size) - 1)

    def _split(self, x):
        n = self.line_dim
        return x[..., :n], x[..., n:]

    def plus(self, x, delta):
        n = self.line_dim
        origin, direction = self._split(x)
        d_origin = delta[..., : n - 1]
        d_dir = delta[..., n - 1 :]

        v, beta = _householder(direction)

        # origin: embed the tangent step in the hyperplane orthogonal to
        # the direction, i.e. the span of the first n-1 Householder basis
        # vectors, scaled by ||direction|| (Ceres semantics)
        y_o = jnp.concatenate([d_origin, jnp.zeros_like(d_origin[..., :1])], axis=-1)
        r = jnp.linalg.norm(direction)
        origin_plus = origin + r * _apply_householder(v, beta, y_o)

        # direction: sphere exponential map
        n2 = jnp.sum(d_dir * d_dir)
        small = n2 < _SMALL
        nd = jnp.sqrt(jnp.where(small, 1.0, n2))
        sinc = jnp.where(small, 1.0 - n2 / 6.0, jnp.sin(nd) / nd)
        w = jnp.where(small, 1.0 - n2 / 2.0, jnp.cos(nd))
        y_d = jnp.concatenate([sinc * d_dir, w[None]])
        dir_plus = r * _apply_householder(v, beta, y_d)
        return jnp.concatenate([origin_plus, dir_plus], axis=-1)

    def minus(self, y, x):
        origin_y, dir_y = self._split(y)
        origin_x, dir_x = self._split(x)
        v, beta = _householder(dir_x)
        r = jnp.linalg.norm(dir_x)

        # origin tangent: project the difference back through the basis
        h_o = _apply_householder(v, beta, (origin_y - origin_x) / r)
        d_origin = h_o[..., :-1]

        # direction tangent: sphere log map
        hy = _apply_householder(v, beta, dir_y) / jnp.linalg.norm(dir_y)
        head, last = hy[:-1], hy[-1]
        hn2 = jnp.sum(head * head)
        small = hn2 < _SMALL
        hn = jnp.sqrt(jnp.where(small, 1.0, hn2))
        angle = jnp.arctan2(hn, last)
        k = jnp.where(small, 1.0 / jnp.where(small, last, 1.0), angle / hn)
        return jnp.concatenate([d_origin, k * head], axis=-1)


class AngleManifold(Manifold):
    """SO(2) as a single angle with wraparound to (-pi, pi].

    Counterpart of the 2D pose-graph example's angle local parameterization
    in the reference lineage (``examples/slam/pose_graph_2d``).
    """

    ambient_size = 1
    tangent_size = 1

    @staticmethod
    def normalize(a):
        return a - 2.0 * jnp.pi * jnp.floor((a + jnp.pi) / (2.0 * jnp.pi))

    def plus(self, x, delta):
        return self.normalize(x + delta)

    def minus(self, y, x):
        return self.normalize(y - x)


class ProductManifold(Manifold):
    """Cartesian product of manifolds over contiguous coordinate spans."""

    def __init__(self, *manifolds: Manifold):
        self.manifolds = tuple(manifolds)
        self.ambient_size = sum(m.ambient_size for m in manifolds)
        self.tangent_size = sum(m.tangent_size for m in manifolds)

    def _spans(self):
        a = t = 0
        for m in self.manifolds:
            yield m, a, t
            a += m.ambient_size
            t += m.tangent_size

    def plus(self, x, delta):
        parts = [
            m.plus(x[a : a + m.ambient_size], delta[t : t + m.tangent_size])
            for m, a, t in self._spans()
        ]
        return jnp.concatenate(parts, axis=-1)

    def minus(self, y, x):
        parts = [
            m.minus(y[a : a + m.ambient_size], x[a : a + m.ambient_size])
            for m, a, t in self._spans()
        ]
        return jnp.concatenate(parts, axis=-1)

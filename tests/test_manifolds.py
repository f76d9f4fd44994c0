"""Manifold property harness (counterpart of the reference lineage's
manifold_test_utils.h): for every manifold M and points x, y:

  1. plus(x, 0) == x
  2. minus(plus(x, d), x) == d         (for small d)
  3. minus(x, x) == 0
  4. plus(x, minus(y, x)) == y
  5. plus_jacobian matches numeric differentiation
  6. everything stays finite and jvp-safe at d == 0
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skeres.models import manifolds as M

RNG = np.random.default_rng(3)


def _unit(v):
    return v / np.linalg.norm(v)


def make_cases():
    cases = []
    euc = M.EuclideanManifold(4)
    cases.append(("euclidean", euc, [jnp.asarray(RNG.normal(size=4)) for _ in range(4)]))

    sub = M.SubsetManifold(5, [1, 3])
    cases.append(("subset", sub, [jnp.asarray(RNG.normal(size=5)) for _ in range(4)]))

    quat = M.QuaternionManifold()
    qs = [jnp.asarray(_unit(RNG.normal(size=4))) for _ in range(6)]
    qs.append(jnp.array([1.0, 0, 0, 0]))
    qs.append(jnp.array([0.0, 1.0, 0, 0]))
    cases.append(("quaternion", quat, qs))

    equat = M.EigenQuaternionManifold()
    cases.append(
        ("eigen_quaternion", equat, [jnp.asarray(_unit(RNG.normal(size=4))) for _ in range(6)])
    )

    sph = M.SphereManifold(4)
    xs = [jnp.asarray(_unit(RNG.normal(size=4))) for _ in range(6)]
    xs.append(jnp.array([0.0, 0.0, 0.0, 1.0]))
    xs.append(jnp.array([0.0, 0.0, 0.0, -1.0]))
    cases.append(("sphere", sph, xs))

    line = M.LineManifold(3)
    ls = [
        jnp.concatenate(
            [jnp.asarray(RNG.normal(size=3)), jnp.asarray(_unit(RNG.normal(size=3)))]
        )
        for _ in range(3)
    ]
    # non-unit direction: the manifold preserves ||direction||
    ls.append(
        jnp.concatenate(
            [jnp.asarray(RNG.normal(size=3)), 2.5 * jnp.asarray(_unit(RNG.normal(size=3)))]
        )
    )
    cases.append(("line", line, ls))

    ang = M.AngleManifold()
    cases.append(
        ("angle", ang, [jnp.asarray(RNG.uniform(-np.pi, np.pi, size=1)) for _ in range(4)])
    )

    prod = M.ProductManifold(M.QuaternionManifold(), M.EuclideanManifold(3))
    ps = [
        jnp.concatenate([jnp.asarray(_unit(RNG.normal(size=4))), jnp.asarray(RNG.normal(size=3))])
        for _ in range(4)
    ]
    cases.append(("product", prod, ps))
    return cases


CASES = make_cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,man,points", CASES, ids=IDS)
def test_plus_zero_is_identity(name, man, points):
    for x in points:
        zero = jnp.zeros((man.tangent_size,), dtype=x.dtype)
        np.testing.assert_allclose(man.plus(x, zero), x, atol=1e-12)


@pytest.mark.parametrize("name,man,points", CASES, ids=IDS)
def test_minus_plus_round_trip(name, man, points):
    for x in points:
        for scale in [1e-8, 1e-4, 1e-2, 0.5]:
            d = jnp.asarray(RNG.normal(size=man.tangent_size)) * scale
            d2 = man.minus(man.plus(x, d), x)
            np.testing.assert_allclose(d2, d, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("name,man,points", CASES, ids=IDS)
def test_minus_self_is_zero(name, man, points):
    for x in points:
        np.testing.assert_allclose(man.minus(x, x), 0.0, atol=1e-12)


@pytest.mark.parametrize("name,man,points", CASES, ids=IDS)
def test_plus_minus_round_trip(name, man, points):
    # y must be reachable from x (reference harness: y = Plus(x, delta));
    # e.g. SubsetManifold cannot represent arbitrary y - x
    for x in points:
        for scale in [1e-4, 0.3, 1.2]:
            d = jnp.asarray(RNG.normal(size=man.tangent_size)) * scale
            y = man.plus(x, d)
            y2 = man.plus(x, man.minus(y, x))
            np.testing.assert_allclose(y2, y, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("name,man,points", CASES, ids=IDS)
def test_plus_jacobian_matches_numeric(name, man, points):
    eps = 1e-7
    for x in points:
        j = np.asarray(man.plus_jacobian(x))
        assert j.shape == (man.ambient_size, man.tangent_size)
        assert np.all(np.isfinite(j))
        num = np.zeros_like(j)
        for k in range(man.tangent_size):
            d = np.zeros(man.tangent_size)
            d[k] = eps
            fp = np.asarray(man.plus(x, jnp.asarray(d)))
            fm = np.asarray(man.plus(x, jnp.asarray(-d)))
            num[:, k] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(j, num, rtol=1e-5, atol=1e-6)


def test_quaternion_plus_preserves_norm():
    man = M.QuaternionManifold()
    x = jnp.asarray(_unit(RNG.normal(size=4)))
    for scale in [1e-6, 0.1, 1.0, 3.0]:
        d = jnp.asarray(RNG.normal(size=3)) * scale
        y = man.plus(x, d)
        np.testing.assert_allclose(jnp.linalg.norm(y), 1.0, atol=1e-12)


def test_sphere_plus_preserves_norm():
    man = M.SphereManifold(4)
    x = 2.5 * jnp.asarray(_unit(RNG.normal(size=4)))  # radius-2.5 sphere
    for scale in [1e-6, 0.1, 1.0]:
        d = jnp.asarray(RNG.normal(size=3)) * scale
        y = man.plus(x, d)
        np.testing.assert_allclose(jnp.linalg.norm(y), 2.5, atol=1e-10)


def test_angle_wraps():
    man = M.AngleManifold()
    y = man.plus(jnp.array([3.0]), jnp.array([1.0]))
    assert -np.pi < float(y[0]) <= np.pi
    np.testing.assert_allclose(float(y[0]), 4.0 - 2 * np.pi, atol=1e-12)


def test_subset_holds_constants():
    man = M.SubsetManifold(4, [0, 2])
    x = jnp.arange(4.0)
    d = jnp.array([10.0, 20.0])
    y = man.plus(x, d)
    np.testing.assert_allclose(y, [0.0, 11.0, 2.0, 23.0])


def test_vmapped_plus():
    """Manifold ops must vmap over batches of blocks — the evaluator relies on it."""
    man = M.QuaternionManifold()
    xs = jnp.asarray(np.stack([_unit(RNG.normal(size=4)) for _ in range(16)]))
    ds = jnp.asarray(RNG.normal(size=(16, 3)) * 0.1)
    ys = jax.vmap(man.plus)(xs, ds)
    assert ys.shape == (16, 4)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(ys), axis=-1), 1.0, atol=1e-12)


def test_jvp_through_plus_at_zero():
    """d/d delta of plus at delta=0 must be finite (the evaluator's hot path)."""
    for man, n in [
        (M.QuaternionManifold(), 4),
        (M.EigenQuaternionManifold(), 4),
        (M.SphereManifold(4), 4),
    ]:
        x = jnp.asarray(_unit(RNG.normal(size=n)))
        zero = jnp.zeros(man.tangent_size)
        tangent = jnp.ones(man.tangent_size)
        _, jv = jax.jvp(lambda d: man.plus(x, d), (zero,), (tangent,))
        assert np.all(np.isfinite(jv))

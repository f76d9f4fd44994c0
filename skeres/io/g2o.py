"""g2o pose-graph file IO (2D and 3D) + synthetic sphere generator.

Counterpart of the reference lineage's g2o readers
(``examples/slam/pose_graph_2d/read_g2o.h`` and
``examples/slam/pose_graph_3d/read_g2o.h``). Supported records:

    VERTEX_SE2 id x y theta
    EDGE_SE2 i j dx dy dtheta  i11 i12 i13 i22 i23 i33
    VERTEX_SE3:QUAT id x y z qx qy qz qw
    EDGE_SE3:QUAT  i j dx dy dz qx qy qz qw  <21 upper-tri info entries>

Information matrices are converted to square-root form (Cholesky L^T) once
at load time so the residual is a single matvec. Because this environment
cannot download sphere2500, ``synthetic_sphere`` generates an equivalent
noisy sphere-trajectory pose graph with odometry + loop-closure edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "PoseGraph2D",
    "PoseGraph3D",
    "load_g2o",
    "synthetic_sphere",
    "build_pose_graph_problem",
]


@dataclasses.dataclass
class PoseGraph2D:
    poses: np.ndarray  # (n, 3) x, y, yaw — index == vertex id order
    ids: np.ndarray  # (n,) original vertex ids
    edges: np.ndarray  # (m, 2) int32 indices into poses
    measurements: np.ndarray  # (m, 3) dx, dy, dyaw
    sqrt_information: np.ndarray  # (m, 3, 3) L^T with L L^T = Info

    @property
    def dim(self):
        return 2


@dataclasses.dataclass
class PoseGraph3D:
    poses: np.ndarray  # (n, 7) px py pz qx qy qz qw
    ids: np.ndarray
    edges: np.ndarray  # (m, 2)
    t_ab: np.ndarray  # (m, 3)
    q_ab: np.ndarray  # (m, 4) xyzw
    sqrt_information: np.ndarray  # (m, 6, 6)

    @property
    def dim(self):
        return 3


def _sqrt_info(info: np.ndarray) -> np.ndarray:
    """Upper-triangular square root L^T of a batch of SPD matrices."""
    return np.transpose(np.linalg.cholesky(info), (0, 2, 1))


def _unpack_upper(vals: np.ndarray, n: int) -> np.ndarray:
    """(m, n(n+1)/2) upper-triangular rows -> (m, n, n) symmetric."""
    m = vals.shape[0]
    out = np.zeros((m, n, n))
    iu = np.triu_indices(n)
    out[:, iu[0], iu[1]] = vals
    out = out + np.transpose(out, (0, 2, 1))
    out[:, np.arange(n), np.arange(n)] /= 2.0
    return out


def load_g2o(path: str):
    """Parse a g2o file; returns PoseGraph2D or PoseGraph3D."""
    v2, v3 = [], []
    e2, e3 = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            vals = [float(x) for x in parts[1:]]
            if tag == "VERTEX_SE2":
                v2.append(vals)
            elif tag == "EDGE_SE2":
                e2.append(vals)
            elif tag == "VERTEX_SE3:QUAT":
                v3.append(vals)
            elif tag == "EDGE_SE3:QUAT":
                e3.append(vals)

    if v2 and not v3:
        v = np.asarray(v2)
        order = np.argsort(v[:, 0], kind="stable")
        v = v[order]
        ids = v[:, 0].astype(np.int64)
        id2row = {int(i): r for r, i in enumerate(ids)}
        e = np.asarray(e2)
        edges = np.asarray(
            [[id2row[int(r[0])], id2row[int(r[1])]] for r in e], dtype=np.int32
        )
        meas = e[:, 2:5]
        info = _unpack_upper(e[:, 5:11], 3)
        return PoseGraph2D(
            poses=np.ascontiguousarray(v[:, 1:4]),
            ids=ids,
            edges=edges,
            measurements=np.ascontiguousarray(meas),
            sqrt_information=_sqrt_info(info),
        )
    if v3:
        v = np.asarray(v3)
        order = np.argsort(v[:, 0], kind="stable")
        v = v[order]
        ids = v[:, 0].astype(np.int64)
        id2row = {int(i): r for r, i in enumerate(ids)}
        e = np.asarray(e3)
        edges = np.asarray(
            [[id2row[int(r[0])], id2row[int(r[1])]] for r in e], dtype=np.int32
        )
        t_ab = e[:, 2:5]
        q_ab = e[:, 5:9]
        # normalize measured quaternions (g2o files are not always exact)
        q_ab = q_ab / np.linalg.norm(q_ab, axis=1, keepdims=True)
        info = _unpack_upper(e[:, 9:30], 6)
        return PoseGraph3D(
            poses=np.ascontiguousarray(v[:, 1:8]),
            ids=ids,
            edges=edges,
            t_ab=np.ascontiguousarray(t_ab),
            q_ab=np.ascontiguousarray(q_ab),
            sqrt_information=_sqrt_info(info),
        )
    raise ValueError(f"no supported g2o records found in {path}")


# -- synthetic sphere (stand-in for sphere2500; no network) --------------------


def _np_quat_mul(a, b):
    """wxyz quaternion product, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_quat_rotate(q, p):
    """Rotate p by unit quaternion q (wxyz), batched."""
    qp = np.concatenate([np.zeros_like(p[..., :1]), p], axis=-1)
    return _np_quat_mul(_np_quat_mul(q, qp), _np_quat_conj(q))[..., 1:]


def _np_aa_to_quat(aa):
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = theta < 1e-12
    axis = aa / np.where(small, 1.0, theta)
    half = 0.5 * theta
    return np.concatenate(
        [np.cos(half), np.where(small, 0.5 * aa, np.sin(half) * axis)], axis=-1
    )


def synthetic_sphere(
    num_poses: int = 2500,
    loops_every: int = 50,
    noise_t: float = 0.05,
    noise_r: float = 0.01,
    seed: int = 11,
) -> PoseGraph3D:
    """Sphere-trajectory 3D pose graph with odometry + loop closures —
    structurally equivalent to the sphere2500 dataset used by the
    reference's pose_graph_3d example (config 3, BASELINE.md)."""
    rng = np.random.default_rng(seed)

    # ground-truth trajectory: spiral on a sphere
    t = np.linspace(0, 1, num_poses)
    phi = np.arccos(1 - 2 * t)  # polar angle sweeps 0..pi
    theta = 24 * np.pi * t  # many revolutions
    radius = 25.0
    pts = radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    )

    # ground-truth orientations: heading along the trajectory
    fwd = np.diff(pts, axis=0, append=pts[-1:] + (pts[-1:] - pts[-2:-1]))
    fwd = fwd / np.maximum(np.linalg.norm(fwd, axis=1, keepdims=True), 1e-9)
    up = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    left = np.cross(up, fwd)
    left /= np.maximum(np.linalg.norm(left, axis=1, keepdims=True), 1e-9)
    up2 = np.cross(fwd, left)
    r_wb = np.stack([fwd, left, up2], axis=2)  # (n, 3, 3) body->world

    # rotation matrices -> wxyz quaternions (Shepperd, vectorized, via trace)
    q = np.zeros((num_poses, 4))
    for i in range(num_poses):
        m = r_wb[i]
        tr = np.trace(m)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                    (m[1, 0] - m[0, 1]) / s]
        else:
            k = np.argmax(np.diag(m))
            i1, i2, i3 = k, (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(m[i1, i1] - m[i2, i2] - m[i3, i3] + 1.0) * 2
            qv = np.zeros(4)
            qv[1 + i1] = 0.25 * s
            qv[0] = (m[i3, i2] - m[i2, i3]) / s
            qv[1 + i2] = (m[i2, i1] + m[i1, i2]) / s
            qv[1 + i3] = (m[i3, i1] + m[i1, i3]) / s
            q[i] = qv
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    # edges: odometry chain + loop closures to the *nearest* earlier pose
    # (guarantees every loop candidate actually closes a loop — otherwise a
    # noisy-odometry-integrated initialization satisfies every constraint
    # exactly and the problem starts at zero cost)
    edges = [(i, i + 1) for i in range(num_poses - 1)]
    for i in range(loops_every, num_poses, loops_every):
        cutoff = max(1, i - loops_every)
        d2 = np.sum((pts[:cutoff] - pts[i]) ** 2, axis=1)
        j = int(np.argmin(d2))
        edges.append((j, int(i)))
    edges = np.asarray(edges, dtype=np.int32)

    ia, ib = edges[:, 0], edges[:, 1]
    q_a, q_b = q[ia], q[ib]
    # true relative measurements in frame a
    q_a_inv = _np_quat_conj(q_a)
    t_ab = _np_quat_rotate(q_a_inv, pts[ib] - pts[ia])
    q_ab = _np_quat_mul(q_a_inv, q_b)

    # add measurement noise
    m = len(edges)
    t_ab = t_ab + rng.normal(0, noise_t, (m, 3))
    dq = _np_aa_to_quat(rng.normal(0, noise_r, (m, 3)))
    q_ab = _np_quat_mul(q_ab, dq)
    q_ab /= np.linalg.norm(q_ab, axis=1, keepdims=True)

    info = np.broadcast_to(
        np.diag(np.concatenate([np.full(3, 1.0 / noise_t**2),
                                np.full(3, 1.0 / noise_r**2)])),
        (m, 6, 6),
    ).copy()

    # noisy initial poses: integrate noisy odometry from pose 0
    poses = np.zeros((num_poses, 7))
    cur_p, cur_q = pts[0].copy(), q[0].copy()
    poses[0, :3] = cur_p
    poses[0, 3:] = np.concatenate([cur_q[1:], cur_q[:1]])  # wxyz -> xyzw
    for k in range(num_poses - 1):
        # odometry edge k connects (k, k+1) by construction
        cur_p = cur_p + _np_quat_rotate(cur_q[None], t_ab[k][None])[0]
        cur_q = _np_quat_mul(cur_q[None], q_ab[k][None])[0]
        cur_q /= np.linalg.norm(cur_q)
        poses[k + 1, :3] = cur_p
        poses[k + 1, 3:] = np.concatenate([cur_q[1:], cur_q[:1]])

    # quaternions to Eigen xyzw order for the measurement arrays too
    q_ab_xyzw = np.concatenate([q_ab[:, 1:], q_ab[:, :1]], axis=1)

    return PoseGraph3D(
        poses=poses,
        ids=np.arange(num_poses),
        edges=edges,
        t_ab=t_ab,
        q_ab=q_ab_xyzw,
        sqrt_information=_sqrt_info(info),
    )


# -- problem construction -------------------------------------------------------


def build_pose_graph_problem(graph, loss=None):
    """Build a Problem from a pose graph (2D or 3D); the first pose is held
    constant to fix the gauge, like the reference examples."""
    from skeres.core.problem import Problem
    from skeres.models.pose_graph import (
        pose_graph_2d_error,
        pose_graph_3d_error,
        se2_manifold,
        se3_manifold,
    )

    problem = Problem()
    if isinstance(graph, PoseGraph2D):
        poses = problem.add_parameter_block_array(
            graph.poses, manifold=se2_manifold(), name="poses2d"
        )
        data = dict(
            t_ab=graph.measurements[:, :2],
            yaw_ab=graph.measurements[:, 2],
            sqrt_information=graph.sqrt_information,
        )
        problem.add_residual_blocks(
            pose_graph_2d_error,
            loss,
            [(poses, graph.edges[:, 0]), (poses, graph.edges[:, 1])],
            data=data,
            name="se2_edge",
        )
    else:
        poses = problem.add_parameter_block_array(
            graph.poses, manifold=se3_manifold(), name="poses3d"
        )
        data = dict(
            t_ab=graph.t_ab,
            q_ab=graph.q_ab,
            sqrt_information=graph.sqrt_information,
        )
        problem.add_residual_blocks(
            pose_graph_3d_error,
            loss,
            [(poses, graph.edges[:, 0]), (poses, graph.edges[:, 1])],
            data=data,
            name="se3_edge",
        )
    problem.set_parameter_block_constant(poses[0])
    return problem, poses

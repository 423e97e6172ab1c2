"""Pose-graph optimization (PGO), batched over SE3 edges.

Capability parity with the reference's PoseGraphOptimization
(reference src/ssvio/loopclosing.cpp:458-594): all keyframes as SE3
vertices, odometry edges (relative pose to previous KF) + loop edges,
residual `log(Z^-1 X_i X_j^-1)` (reference include/ssvio/g2otypes.hpp:
164-199), active/loop/first vertices held fixed, ~20 LM iterations.

Edges live in flat arrays (i, j, Z, valid); residuals and first-order SE3
Jacobians are one vmapped pass; the Gauss-Newton normal system is solved
dense (jittered Cholesky on the [6P, 6P] block matrix, one batched dense
solve instead of a sparse scalar factorization at small P) up to
DENSE_MAX_POSES, and with matrix-free Jacobi-preconditioned CG beyond
(O(E) memory per matvec; KITTI-02-scale keyframe counts never build H).

Jacobians use the standard second-order inverse-left-Jacobian
approximation: J0 = Jl^{-1}(r) Ad(Z^{-1}), J1 = -Jr^{-1}(r), with
Jl^{-1}(xi) ≈ I - 0.5 ad(xi) + (1/12) ad(xi)^2 (exact enough for the
residual magnitudes PGO sees; the LM loop handles the rest).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssvio_tpu.ops import se3


def se3_ad(xi: jnp.ndarray) -> jnp.ndarray:
    """adjoint (little ad) of a twist [..., 6] -> [..., 6, 6]
    for [rho, phi] ordering: [[hat(phi), hat(rho)], [0, hat(phi)]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    hp = se3.hat(phi)
    hr = se3.hat(rho)
    z = jnp.zeros_like(hp)
    top = jnp.concatenate([hp, hr], axis=-1)
    bot = jnp.concatenate([z, hp], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _jl_inv(xi: jnp.ndarray) -> jnp.ndarray:
    """Inverse left Jacobian of SE3, 2nd-order series. [..., 6] -> [..., 6, 6]."""
    a = se3_ad(xi)
    eye = jnp.broadcast_to(jnp.eye(6, dtype=xi.dtype), a.shape)
    return eye - 0.5 * a + (1.0 / 12.0) * (a @ a)


def _jr_inv(xi: jnp.ndarray) -> jnp.ndarray:
    a = se3_ad(xi)
    eye = jnp.broadcast_to(jnp.eye(6, dtype=xi.dtype), a.shape)
    return eye + 0.5 * a + (1.0 / 12.0) * (a @ a)


class PGOProblem(NamedTuple):
    poses: jnp.ndarray      # [P, 3, 4] T_cw per keyframe slot
    pose_valid: jnp.ndarray # [P] bool
    pose_fixed: jnp.ndarray # [P] bool (active window + loop KF + first KF)
    edge_i: jnp.ndarray     # [E] int32 vertex 0
    edge_j: jnp.ndarray     # [E] int32 vertex 1
    edge_Z: jnp.ndarray     # [E, 3, 4] measured T_cwi * T_cwj^-1
    edge_valid: jnp.ndarray # [E] bool
    edge_weight: jnp.ndarray  # [E] float (information scale; 1.0 typical)


def _edge_residuals(poses, prob: PGOProblem):
    Xi = poses[prob.edge_i]
    Xj = poses[prob.edge_j]
    A = se3.compose(se3.compose(se3.inverse(prob.edge_Z), Xi), se3.inverse(Xj))
    r = se3.log(A)                                  # [E, 6]
    return r


def _linearize_edges(poses, prob: PGOProblem, free_mask):
    """Per-edge linearization shared by the dense and CG solvers.

    Returns (r [E,6], w [E], J0 [E,6,6], J1 [E,6,6], b [P,6], F) with
    fixed vertices' Jacobian blocks zeroed."""
    P = poses.shape[0]
    r = _edge_residuals(poses, prob)
    # non-finite residuals (e.g. a degenerate edge whose rotation lands on
    # the log-map branch cut) must not poison the whole solve: one NaN in F
    # makes every LM step rejected and PGO silently returns its input
    r_ok = jnp.all(jnp.isfinite(r), axis=-1)
    r = jnp.where(r_ok[:, None], r, 0.0)
    w = (prob.edge_valid & r_ok
         & prob.pose_valid[prob.edge_i]
         & prob.pose_valid[prob.edge_j]).astype(poses.dtype) * prob.edge_weight
    # Huber robust weight on the edge residual norm (delta = 1.0 in the
    # normalized residual units): bounds a bad edge's pull on the graph
    # like g2o's RobustKernelHuber would (the reference uses identity
    # information with no kernel; one wild edge then dominates — the same
    # class of failure the NaN guard above handles at infinity)
    rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
    delta = 1.0
    w = w * jnp.where(rn <= delta, 1.0, delta / rn)
    F = jnp.sum(w * jnp.sum(r * r, axis=-1))
    Jl_inv = _jl_inv(r)
    AdZinv = se3.adjoint(se3.inverse(prob.edge_Z))
    J0 = Jl_inv @ AdZinv                            # [E, 6, 6]
    J1 = -_jr_inv(r)
    J0 = J0 * free_mask[prob.edge_i][:, None, None]
    J1 = J1 * free_mask[prob.edge_j][:, None, None]
    b0 = -jnp.einsum("eba,eb->ea", J0, r * w[:, None])
    b1 = -jnp.einsum("eba,eb->ea", J1, r * w[:, None])
    b = jnp.zeros((P, 6), dtype=poses.dtype)
    b = b.at[prob.edge_i].add(b0)
    b = b.at[prob.edge_j].add(b1)
    return r, w, J0, J1, b, F


def _build_normal_system(poses, prob: PGOProblem, free_mask):
    """Returns (H [P,P,6,6] dense, b [P,6], F cost)."""
    P = poses.shape[0]
    _, w, J0, J1, b, F = _linearize_edges(poses, prob, free_mask)
    we = w[:, None, None]
    H00 = jnp.swapaxes(J0, -1, -2) @ J0 * we        # [E, 6, 6]
    H11 = jnp.swapaxes(J1, -1, -2) @ J1 * we
    H01 = jnp.swapaxes(J0, -1, -2) @ J1 * we
    H = jnp.zeros((P, P, 6, 6), dtype=poses.dtype)
    H = H.at[prob.edge_i, prob.edge_i].add(H00)
    H = H.at[prob.edge_j, prob.edge_j].add(H11)
    H = H.at[prob.edge_i, prob.edge_j].add(H01)
    H = H.at[prob.edge_j, prob.edge_i].add(jnp.swapaxes(H01, -1, -2))
    return H, b, F


# above this pose count the dense [6P, 6P] factorization (P^2*36 floats:
# ~600 MB at P=2048) gives way to the matrix-free CG solver
DENSE_MAX_POSES = 512


def optimize(prob: PGOProblem, iters: int = 20) -> jnp.ndarray:
    """LM pose-graph optimization. Returns optimized poses [P, 3, 4].

    Dispatches on problem size (a static shape, so each variant jits
    once): dense Cholesky on the [6P, 6P] normal system up to
    DENSE_MAX_POSES, matrix-free Jacobi-block-preconditioned CG beyond —
    the fixed-shape analog of the reference's sparse solve over ALL keyframes
    (reference loopclosing.cpp:458-594, LinearSolverEigen)."""
    if prob.poses.shape[0] <= DENSE_MAX_POSES:
        return _optimize_dense(prob, iters=iters)
    return _optimize_cg(prob, iters=iters)


@functools.partial(jax.jit, static_argnames=("iters",))
def _optimize_dense(prob: PGOProblem, iters: int = 20) -> jnp.ndarray:
    P = prob.poses.shape[0]
    free = (prob.pose_valid & ~prob.pose_fixed).astype(prob.poses.dtype)

    H0, _, _ = _build_normal_system(prob.poses, prob, free)
    diag0 = jnp.abs(jnp.einsum("ppii->pi", H0))
    lam0 = 1e-5 * jnp.max(diag0) + 1e-8

    def body(_, carry):
        poses, lam, nu = carry
        H, b, F = _build_normal_system(poses, prob, free)
        Hd = H.transpose(0, 2, 1, 3).reshape(P * 6, P * 6)
        freev = jnp.repeat(free, 6)
        mask = freev[:, None] * freev[None, :]
        Hd = Hd * mask
        Hd = Hd + jnp.diag(jnp.where(freev > 0, lam, 1.0))
        rhs = b.reshape(-1) * freev
        L, low = jax.scipy.linalg.cho_factor(
            Hd + 1e-8 * jnp.eye(P * 6, dtype=Hd.dtype), lower=True)
        dx = jax.scipy.linalg.cho_solve((L, low), rhs).reshape(P, 6)
        dx = dx * free[:, None]
        poses_new = se3.compose(se3.exp(dx), poses)
        _, _, F_new = _build_normal_system(poses_new, prob, free)
        pred = 0.5 * jnp.sum(dx.reshape(-1) * (lam * dx.reshape(-1) + rhs))
        rho = (F - F_new) / jnp.maximum(pred, 1e-12)
        accept = (rho > 0) & jnp.all(jnp.isfinite(dx))
        poses = jnp.where(accept, poses_new, poses)
        lam = jnp.where(accept,
                        lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                        lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return poses, lam, nu

    poses, _, _ = jax.lax.fori_loop(0, iters, body,
                                    (prob.poses, lam0, jnp.float32(2.0)))
    return poses


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def _optimize_cg(prob: PGOProblem, iters: int = 20,
                 cg_iters: int | None = None) -> jnp.ndarray:
    """Large-P LM via matrix-free preconditioned CG.

    Never materializes H: each CG matvec is two gathers + two batched
    6x6 matmuls + two segment scatter-adds over the edge list (O(E)
    memory). Preconditioner = per-pose Jacobi 6x6 blocks (batched
    inverse). Information on a chain graph travels one vertex per CG
    step, so the iteration cap defaults to P (with an early exit on
    relative residual) — each matvec is tiny, the cap just bounds the
    while_loop."""
    P = prob.poses.shape[0]
    if cg_iters is None:
        cg_iters = 2 * P
    free = (prob.pose_valid & ~prob.pose_fixed).astype(prob.poses.dtype)
    ei, ej = prob.edge_i, prob.edge_j

    def solve(J0, J1, w, lam, Minv, rhs):
        def matvec(v):
            u = (jnp.einsum("eab,eb->ea", J0, v[ei])
                 + jnp.einsum("eab,eb->ea", J1, v[ej])) * w[:, None]
            out = jnp.zeros_like(v)
            out = out.at[ei].add(jnp.einsum("eba,eb->ea", J0, u))
            out = out.at[ej].add(jnp.einsum("eba,eb->ea", J1, u))
            return (out + lam * v) * free[:, None]

        def prec(v):
            return jnp.einsum("pab,pb->pa", Minv, v) * free[:, None]

        x0 = jnp.zeros_like(rhs)
        r0 = rhs                       # x0 = 0
        z0 = prec(r0)
        rz0 = jnp.sum(r0 * z0)
        tol2 = 1e-10 * jnp.maximum(rz0, 1e-30)

        def cond(c):
            k, _, _, _, rz = c
            return (k < cg_iters) & (rz > tol2)

        def body(c):
            k, x, r, p, rz = c
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = jnp.sum(r * z)
            p = z + (rz_new / jnp.maximum(rz, 1e-30)) * p
            return k + 1, x, r, p, rz_new

        _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, z0, rz0))
        return x

    def linearize(poses):
        _, w, J0, J1, b, F = _linearize_edges(poses, prob, free)
        D = jnp.zeros((P, 6, 6), dtype=poses.dtype)
        we = w[:, None, None]
        D = D.at[ei].add(jnp.swapaxes(J0, -1, -2) @ J0 * we)
        D = D.at[ej].add(jnp.swapaxes(J1, -1, -2) @ J1 * we)
        return w, J0, J1, b, F, D

    _, _, _, _, _, D0 = linearize(prob.poses)
    diag0 = jnp.abs(jnp.einsum("pii->pi", D0))
    lam0 = 1e-5 * jnp.max(diag0) + 1e-8

    def body(_, carry):
        poses, lam, nu = carry
        w, J0, J1, b, F, D = linearize(poses)
        eye = jnp.eye(6, dtype=poses.dtype)
        Minv = jnp.linalg.inv(D + (lam + 1e-8) * eye[None])
        rhs = b * free[:, None]
        dx = solve(J0, J1, w, lam, Minv, rhs) * free[:, None]
        poses_new = se3.compose(se3.exp(dx), poses)
        _, _, _, _, F_new, _ = linearize(poses_new)
        pred = 0.5 * jnp.sum(dx.reshape(-1) * (lam * dx.reshape(-1)
                                               + rhs.reshape(-1)))
        rho = (F - F_new) / jnp.maximum(pred, 1e-12)
        accept = (rho > 0) & jnp.all(jnp.isfinite(dx))
        poses = jnp.where(accept, poses_new, poses)
        lam = jnp.where(accept,
                        lam * jnp.maximum(1.0 / 3.0,
                                          1.0 - (2.0 * rho - 1.0) ** 3),
                        lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return poses, lam, nu

    poses, _, _ = jax.lax.fori_loop(0, iters, body,
                                    (prob.poses, lam0, jnp.float32(2.0)))
    return poses


def make_odometry_edges(poses: jnp.ndarray, n_valid: int | jnp.ndarray,
                        capacity: int):
    """Helper: consecutive-KF odometry edges from current pose estimates
    (the reference records relative_pose_to_last_KF at creation time,
    keyframe.hpp:38-41 — callers should pass those instead when available)."""
    P = poses.shape[0]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    i = jnp.minimum(idx + 1, P - 1)
    j = idx
    Z = se3.compose(poses[i], se3.inverse(poses[j]))
    valid = (idx + 1) < n_valid
    return i, j, Z, valid

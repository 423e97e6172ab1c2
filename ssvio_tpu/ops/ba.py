"""Batched Gauss-Newton / Levenberg-Marquardt optimizers.

This module is the tensor-form replacement for the reference's g2o stack:

- `pose_only_optimize` == the frontend's EstimateCurrentPose
  (reference src/ssvio/frontend.cpp:184-300): 1 pose, N reprojection edges,
  4 rounds x 10 LM iterations, Huber (dropped in the last round),
  chi2 > 5.991 outlier demotion between rounds.
- `local_ba` == the backend's OptimizeActiveMap
  (reference src/ssvio/backend.cpp:78-245): W poses + M landmarks, left and
  right-camera reprojection edges, Schur-complement marginalization of the
  3x3 landmark blocks, LM with g2o's adaptive-lambda gain-ratio schedule
  (reference thirdparty g2o optimization_algorithm_levenberg.cpp:89-147),
  inlier-ratio outer loop, observation detachment.

Design (not a port): no graph objects. Observations live in a
dense `[M, W, C]` table (C = 2 eyes), so residuals/Jacobians are one vmapped
elementwise pass, Hessian blocks are einsum contractions,
and the Schur reduction is a single `[M]`-batched 3x3 solve + `[W x W]`
block contraction. Fixed/free poses are handled with masks, invalid
observations with zero weights — shapes never change, everything jits once.

Precision: normal equations accumulate in float32 with
`jax_default_matmul_precision=highest` (set at package import); the reduced
camera system is <= 96x96, solved with a jittered Cholesky.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ssvio_tpu.ops import se3

CHI2_TH = 5.991          # 95% chi-square with 2 dof (reference threshold)


# ---------------------------------------------------------------------------
# Reprojection residuals / Jacobians (analytic, matching g2otypes.hpp:86-101)
# ---------------------------------------------------------------------------

def reproject_residual(T_cw: jnp.ndarray, p_w: jnp.ndarray, uv: jnp.ndarray,
                       fx, fy, cx, cy, baseline_x: jnp.ndarray | float = 0.0):
    """Residual r = uv_obs - proj(T_cw p_w + [-baseline_x, 0, 0]).

    Broadcasts over leading dims. baseline_x > 0 selects the right eye.
    Returns (r [..., 2], p_c [..., 3] LEFT-camera point, z_positive [...]).
    """
    p_cl = se3.transform(T_cw, p_w)
    p_c = p_cl + jnp.stack([-jnp.broadcast_to(jnp.asarray(baseline_x, p_cl.dtype), p_cl[..., 0].shape),
                            jnp.zeros_like(p_cl[..., 0]),
                            jnp.zeros_like(p_cl[..., 0])], axis=-1)
    z = p_c[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * p_c[..., 0] / safe_z + cx
    v = fy * p_c[..., 1] / safe_z + cy
    r = uv - jnp.stack([u, v], axis=-1)
    return r, p_cl, z > 0.05


def reproject_jacobians(p_cl: jnp.ndarray, R_cw: jnp.ndarray,
                        fx, fy, baseline_x: jnp.ndarray | float = 0.0):
    """Analytic Jacobians of the reprojection residual.

    Args:
      p_cl: [..., 3] LEFT-camera-frame point (before baseline shift).
      R_cw: [..., 3, 3] rotation of the pose being optimized.

    Returns:
      J_pose [..., 2, 6] d r / d xi with LEFT-multiplicative update
        T <- Exp(xi) T, xi = [rho, phi] (translation, rotation);
      J_point [..., 2, 3] d r / d p_w.

    Matches the reference's analytic pose-only Jacobian
    (g2otypes.hpp:86-101) generalized with the stereo baseline offset
    (backend edges use the right-eye extrinsic, backend.cpp:147-155).
    """
    x, y = p_cl[..., 0], p_cl[..., 1]
    z = p_cl[..., 2]
    bx = jnp.broadcast_to(jnp.asarray(baseline_x, p_cl.dtype), z.shape)
    xs = x - bx                     # x in the shifted (projecting) camera
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zero = jnp.zeros_like(iz)
    # d proj / d p_c (projecting camera coords) [..., 2, 3]
    duv = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * xs * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
    ], axis=-2)
    # d p_c / d xi = [I | -hat(p_cl)]  (baseline shift is constant => same)
    dp_dxi = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=p_cl.dtype), (*p_cl.shape[:-1], 3, 3)),
        -se3.hat(p_cl),
    ], axis=-1)                      # [..., 3, 6]
    J_pose = -(duv @ dp_dxi)         # r = obs - proj  =>  dr = -dproj
    J_point = -(duv @ R_cw)
    return J_pose, J_point


def huber_weight(chi2: jnp.ndarray, delta2: float = CHI2_TH) -> jnp.ndarray:
    """IRLS weight of the Huber kernel on squared error chi2 (delta^2 form:
    w = 1 inside, delta/sqrt(chi2) outside — g2o RobustKernelHuber)."""
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


# ---------------------------------------------------------------------------
# Pose-only LM (frontend hot loop)
# ---------------------------------------------------------------------------

class PoseOnlyResult(NamedTuple):
    T_cw: jnp.ndarray        # [3, 4] optimized pose
    inlier: jnp.ndarray      # [N] bool final inlier mask
    n_inliers: jnp.ndarray   # [] int32
    chi2: jnp.ndarray        # [N] final per-edge chi2


def _pose_only_normal_eq(T, p_w, uv, w, fx, fy, cx, cy):
    r, p_cl, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
    w = w * z_ok.astype(r.dtype)
    chi2 = jnp.sum(r * r, axis=-1)
    hw = w * huber_weight(chi2)
    J, _ = reproject_jacobians(p_cl, se3.rotation(T), fx, fy)
    # H = sum w J^T J ; b = -sum w J^T r  (solve H dx = b, update Exp(dx) T)
    H = jnp.einsum("nki,nkj,n->ij", J, J, hw)
    b = -jnp.einsum("nki,nk,n->i", J, r, hw)
    F = jnp.sum(hw * chi2)
    return H, b, F


def _lm_loop_6dof(T0, p_w, uv, weight, fx, fy, cx, cy, iters: int):
    """Adaptive-lambda LM on a single 6-dof pose (g2o Levenberg semantics:
    gain ratio rho, lambda *= max(1/3, 1-(2 rho-1)^3) on success else *= nu).

    The normal equations are CARRIED between iterations (one linearization
    per step, not two) and a while_loop exits once the step stalls — the
    reference's g2o loop also terminates early on no-progress."""

    H0, b0, F0 = _pose_only_normal_eq(T0, p_w, uv, weight, fx, fy, cx, cy)
    lam0 = 1e-5 * jnp.max(jnp.diagonal(H0))

    def cond(carry):
        i, T, lam, nu, HbF, stop = carry
        return (i < iters) & ~stop

    def body(carry):
        i, T, lam, nu, (H, b, F), stop = carry
        A = H + lam * jnp.eye(6, dtype=H.dtype)
        dx = jnp.linalg.solve(A, b)
        T_new = se3.compose(se3.exp(dx), T)
        HbF_new = _pose_only_normal_eq(T_new, p_w, uv, weight, fx, fy, cx, cy)
        F_new = HbF_new[2]
        pred = 0.5 * jnp.dot(dx, lam * dx + b)
        rho = (F - F_new) / jnp.maximum(pred, 1e-12)
        finite = jnp.all(jnp.isfinite(dx))
        accept = (rho > 0) & finite
        T = jnp.where(accept, T_new, T)
        HbF = jax.tree.map(lambda n, o: jnp.where(accept, n, o),
                           HbF_new, (H, b, F))
        lam = jnp.where(accept,
                        lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                        lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        stop = (jnp.max(jnp.abs(dx)) < 1e-7) & finite
        return i + 1, T, lam, nu, HbF, stop

    _, T, _, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), T0, lam0, jnp.float32(2.0),
                     (H0, b0, F0), jnp.asarray(False)))
    return T


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_only_optimize(T_init: jnp.ndarray, p_w: jnp.ndarray, uv: jnp.ndarray,
                       valid: jnp.ndarray, fx, fy, cx, cy,
                       rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """The reference's 4x10 pose-only BA with between-round chi2 gating.

    Between rounds every edge's chi2 is recomputed and edges above CHI2_TH
    are excluded from the next round (they may come back, mirroring the
    reference's setLevel dance, frontend.cpp:244-268). The final round runs
    without the Huber kernel (frontend.cpp:262-265) — here: outliers already
    excluded, weight=1 inside.
    """
    inlier = valid

    T = T_init
    for rnd in range(rounds):
        w = (valid & inlier).astype(jnp.float32)
        T = _lm_loop_6dof(T, p_w, uv, w, fx, fy, cx, cy, iters)
        r, _, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
        chi2 = jnp.sum(r * r, axis=-1)
        inlier = valid & z_ok & (chi2 < CHI2_TH)
    r, _, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
    chi2 = jnp.sum(r * r, axis=-1)
    inlier = valid & z_ok & (chi2 < CHI2_TH)
    return PoseOnlyResult(T, inlier, jnp.sum(inlier.astype(jnp.int32)), chi2)


# ---------------------------------------------------------------------------
# Local bundle adjustment with Schur-complement landmark marginalization
# ---------------------------------------------------------------------------

BACKEND_CHI2_TH = 5.891   # backend threshold (reference backend.cpp:172)


class LocalBAProblem(NamedTuple):
    """Dense sliding-window BA state. W = window capacity, M = landmark
    capacity, C = 2 eyes (left, right). All masked; shapes never change."""
    kf_T_cw: jnp.ndarray      # [W, 3, 4]
    kf_valid: jnp.ndarray     # [W] bool — slot holds a real keyframe
    kf_fixed: jnp.ndarray     # [W] bool — pose held constant
    lm_pos: jnp.ndarray       # [M, 3] world positions
    lm_valid: jnp.ndarray     # [M] bool
    lm_fixed: jnp.ndarray     # [M] bool (first obs outside window => fixed,
                              #   reference backend.cpp:118-126)
    obs_uv: jnp.ndarray       # [M, W, C, 2] pixel observations
    obs_valid: jnp.ndarray    # [M, W, C] bool


class LocalBAResult(NamedTuple):
    kf_T_cw: jnp.ndarray      # [W, 3, 4] optimized poses
    lm_pos: jnp.ndarray       # [M, 3] optimized landmarks
    obs_valid: jnp.ndarray    # [M, W, C] with outlier edges detached
    chi2: jnp.ndarray         # [M, W, C] final per-edge chi2
    inlier_ratio: jnp.ndarray # [] float32


def _ba_residuals(prob: LocalBAProblem, kf_T_cw, lm_pos, fx, fy, cx, cy, bl):
    """All-edge residuals. Returns (r [M,W,C,2], p_cl [M,W,3], z_ok [M,W])."""
    # left-camera points per (m, w): [M, W, 3]
    p_cl = se3.transform(kf_T_cw[None, :, :, :], lm_pos[:, None, :])
    baseline = jnp.stack([jnp.zeros_like(bl), bl])            # [C]
    z = p_cl[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    xs = p_cl[..., 0:1] - baseline[None, None, :]             # [M, W, C]
    u = fx * xs / safe_z[..., None] + cx
    v = (fy * p_cl[..., 1] / safe_z)[..., None] + cy          # [M, W, C]
    uv_hat = jnp.stack([u, jnp.broadcast_to(v, u.shape)], axis=-1)
    r = prob.obs_uv - uv_hat                                  # [M, W, C, 2]
    return r, p_cl, z > 0.05


def _ba_cost_and_blocks(prob: LocalBAProblem, kf_T_cw, lm_pos,
                        fx, fy, cx, cy, bl, edge_active, axis_name=None):
    """One linearization pass: cost F, Hessian blocks and gradients.

    LAYOUT: every big intermediate keeps the landmark axis M LAST, so the
    large axis is the minor one and the small (2, 6) Jacobian tail never
    becomes a padded minor tile. Jacobian components
    are built directly per (row k, column a) as [W, C, M] planes and
    stacked to [W, 6|3, C, 2, M]; all contractions then reduce adjacent
    minor axes (c, k, m) and lower to clean dot_generals.

    Returns (F, Hpp [W,6,6], Hll [3,3,M], Hpl [W,6,3,M], bp [W,6],
    blm [3,M]).

    With `axis_name` set, the landmark axis M is assumed sharded across that
    mesh axis (shard_map): per-landmark blocks (Hll, Hpl, blm) stay local to
    the shard, while the pose-side sums (F, Hpp, bp) are combined with a
    `psum` across the mesh — the distributed-BA reduction of SURVEY §2.3.
    """
    W = kf_T_cw.shape[0]
    R = se3.rotation(kf_T_cw)                                 # [W, 3, 3]
    t = kf_T_cw[:, :, 3]
    P = lm_pos.T                                              # [3, M]
    p_cl = R @ P[None] + t[:, :, None]                        # [W, 3, M]
    x, y, z = p_cl[:, 0], p_cl[:, 1], p_cl[:, 2]              # [W, M]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    baseline = jnp.stack([jnp.zeros_like(bl), bl])            # [C]
    xs = x[:, None, :] - baseline[None, :, None]              # [W, C, M]
    u_hat = fx * xs * iz[:, None, :] + cx                     # [W, C, M]
    v_hat = (fy * y * iz + cy)[:, None, :]                    # [W, 1, M]
    obs = prob.obs_uv.transpose(1, 2, 3, 0)                   # [W, C, 2, M]
    ru = obs[:, :, 0] - u_hat                                 # [W, C, M]
    rv = obs[:, :, 1] - v_hat
    chi2 = ru * ru + rv * rv                                  # [W, C, M]
    z_ok = z > 0.05                                           # [W, M]
    act = edge_active.transpose(1, 2, 0)                      # [W, C, M]
    w_edge = (act & z_ok[:, None, :]).astype(jnp.float32)
    hw = w_edge * huber_weight(chi2, BACKEND_CHI2_TH)         # [W, C, M]
    F = jnp.sum(hw * chi2)

    # Jacobian building blocks (r = obs - proj => leading minus).
    # du = [fx iz, 0, -fx xs iz2], dv = [0, fy iz, -fy y iz2] (per cam c);
    # pose cols a=0..2: identity; a=3..5: (-hat(p_cl)) columns
    # [0,-z,y], [z,0,-x], [-y,x,0]  (left-multiplicative update, matches
    # reference g2otypes.hpp:86-101).
    du_x = jnp.broadcast_to((fx * iz)[:, None, :], xs.shape)   # [W, C, M]
    du_z = -fx * xs * iz2[:, None, :]
    dv_y = fy * iz                                             # [W, M]
    dv_z = -fy * y * iz2
    zero_c = jnp.zeros_like(du_x)
    yc = jnp.broadcast_to(y[:, None, :], xs.shape)
    zc = jnp.broadcast_to(z[:, None, :], xs.shape)
    xc = jnp.broadcast_to(x[:, None, :], xs.shape)
    dv_y_c = jnp.broadcast_to(dv_y[:, None, :], xs.shape)
    dv_z_c = jnp.broadcast_to(dv_z[:, None, :], xs.shape)

    ju = [du_x, zero_c, du_z,
          du_z * yc, du_x * zc - du_z * xc, -du_x * yc]
    jv = [zero_c, dv_y_c, dv_z_c,
          -dv_y_c * zc + dv_z_c * yc, -dv_z_c * xc, dv_y_c * xc]
    # J_pose [W, 6, C, 2, M] — k stacked at axis 2 of each [W,C,M] plane so
    # no post-stack transpose is needed
    J_pose = -jnp.stack([jnp.stack([ju[a], jv[a]], axis=2)
                         for a in range(6)], axis=1)
    # J_point rows: du @ R (cols b) and dv @ R  ->  [W, 3, C, 2, M]
    Rc = R[:, :, :, None, None]                                # [W,3,3,1,1]
    jpu = [du_x * Rc[:, 0, b] + du_z * Rc[:, 2, b] for b in range(3)]
    jpv = [dv_y_c * Rc[:, 1, b] + dv_z_c * Rc[:, 2, b] for b in range(3)]
    J_point = -jnp.stack([jnp.stack([jpu[b], jpv[b]], axis=2)
                          for b in range(3)], axis=1)

    # mask fixed/invalid variables by zeroing their Jacobians
    free_pose = (prob.kf_valid & ~prob.kf_fixed).astype(jnp.float32)
    free_lm = (prob.lm_valid & ~prob.lm_fixed).astype(jnp.float32)
    J_pose = J_pose * free_pose[:, None, None, None, None]
    J_point = J_point * free_lm[None, None, None, None, :]

    r = jnp.stack([ru, rv], axis=2)                           # [W, C, 2, M]
    hw_k = hw[:, :, None, :]                                  # [W, C, 1, M]
    Jp_w = J_pose * hw_k[:, None]                             # fold weights
    rw = r * hw_k
    # Contractions as broadcast-multiply-reduce rather than dot_general:
    # with the batch axis m LAST, XLA's dot lowering would relayout both
    # operands to put m leading; a fused reduce over the small (c, k[, m])
    # axes keeps everything in the M-lane layout.
    Hpp = jnp.sum(Jp_w[:, :, None] * J_pose[:, None], axis=(3, 4, 5))
    Hll = jnp.sum((J_point * hw_k[:, None])[:, :, None] * J_point[:, None],
                  axis=(0, 3, 4))                             # [3,3,M]
    Hpl = jnp.sum(Jp_w[:, :, None] * J_point[:, None], axis=(3, 4))
    bp = -jnp.sum(J_pose * rw[:, None], axis=(2, 3, 4))       # [W,6]
    blm = -jnp.sum(J_point * rw[:, None], axis=(0, 2, 3))     # [3,M]
    if axis_name is not None:
        F = jax.lax.psum(F, axis_name)
        Hpp = jax.lax.psum(Hpp, axis_name)
        bp = jax.lax.psum(bp, axis_name)
    return F, Hpp, Hll, Hpl, bp, blm


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det).

    A cofactor formula is a handful of fused elementwise ops where
    jnp.linalg.inv would run a batched LU. BA damping keeps the blocks
    well-conditioned, so the explicit formula is safe here."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([co_a, co_b, co_c], axis=-1),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def _inv3x3_mlast(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse on [3, 3, M] (batch axis LAST)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([co_a, co_b, co_c], axis=0),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=0),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=0),
    ], axis=0)
    return adj * inv_det[None, None]


def _schur_solve(Hpp, Hll, Hpl, bp, blm, lam, pose_free, lm_free,
                 axis_name=None):
    """Damped Schur-reduced solve on M-last blocks (see _ba_cost_and_blocks
    layout note). Hll [3,3,M], Hpl [W,6,3,M], blm [3,M].
    Returns (dxp [W,6], dxl [M,3]).

    With `axis_name`: Hpp/bp are already global; the landmark-marginalized
    cross terms are shard-local partial sums combined here with psum, the
    tiny reduced camera system is solved redundantly on every shard
    (cheaper than gathering), and back-substitution stays local.
    """
    W = Hpp.shape[0]
    M = Hll.shape[-1]
    eye6 = jnp.eye(6, dtype=Hpp.dtype)
    eye3m = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
    Hpp_d = Hpp + lam * eye6[None]
    # landmarks with no observations / fixed: make their block identity so
    # the batched inverse stays finite (their dxl is masked to 0 anyway).
    Hll_d = Hll + (lam + (1.0 - lm_free))[None, None, :] * eye3m
    Hll_inv = _inv3x3_mlast(Hll_d)                             # [3,3,M]

    # Schur complement: S = Hpp_d - sum_m Hpl Hll^-1 Hpl^T.
    # A = Hpl Hll^-1 per (m, w), then ONE [6W, 3M] x [3M, 6W] matmul —
    # the (3, M) minor axes are adjacent, so the reshape is free.
    A = jnp.einsum("wabm,bcm->wacm", Hpl, Hll_inv)             # [W,6,3,M]
    A2 = A.reshape(W * 6, 3 * M)
    B2 = Hpl.reshape(W * 6, 3 * M)
    S_cross = (A2 @ B2.T).reshape(W, 6, W, 6).transpose(0, 2, 1, 3)
    corr = jnp.einsum("wacm,cm->wa", A, blm)
    if axis_name is not None:
        S_cross = jax.lax.psum(S_cross, axis_name)
        corr = jax.lax.psum(corr, axis_name)
    S = -S_cross
    S = S.at[jnp.arange(W), jnp.arange(W)].add(Hpp_d)
    bs = bp - corr

    # dense [6W, 6W] reduced camera system; fixed poses get identity rows
    Sd = S.transpose(0, 2, 1, 3).reshape(W * 6, W * 6)
    free = jnp.repeat(pose_free, 6)
    mask = free[:, None] * free[None, :]
    Sd = Sd * mask + jnp.diag(jnp.where(free > 0, 0.0, 1.0))
    rhs = bs.reshape(-1) * free
    # LU solve of the small (6W x 6W) damped system; the diagonal jitter
    # keeps fixed-pose rows nonsingular
    dxp = jnp.linalg.solve(Sd + 1e-6 * jnp.eye(W * 6, dtype=Sd.dtype),
                           rhs).reshape(W, 6)
    dxp = dxp * pose_free[:, None]

    # back-substitute landmarks
    rhs_l = blm - jnp.einsum("wabm,wa->bm", Hpl, dxp)          # [3,M]
    dxl = jnp.einsum("cbm,bm->cm", Hll_inv, rhs_l) * lm_free[None, :]
    return dxp, dxl.T


@functools.partial(jax.jit, static_argnames=("max_rounds", "iters",
                                              "axis_name"))
def local_ba(prob: LocalBAProblem, fx, fy, cx, cy, baseline,
             max_rounds: int = 5, iters: int = 10,
             target_inlier_ratio: float = 0.7,
             axis_name: str | None = None) -> LocalBAResult:
    """Sliding-window local BA, g2o-LM semantics on dense masked tensors.

    Outer loop mirrors the reference (backend.cpp:172-203): up to
    `max_rounds` rounds of `iters` LM iterations; after each round edges
    with chi2 > BACKEND_CHI2_TH are counted as outliers and the loop stops
    once the inlier ratio exceeds `target_inlier_ratio` (further rounds are
    frozen — shapes stay static). Afterwards outlier edges are detached
    (reference backend.cpp:207-227).
    """
    bl = jnp.asarray(baseline, jnp.float32)
    pose_free = (prob.kf_valid & ~prob.kf_fixed).astype(jnp.float32)
    lm_has_obs = jnp.any(prob.obs_valid, axis=(1, 2))
    lm_free = (prob.lm_valid & ~prob.lm_fixed & lm_has_obs).astype(jnp.float32)

    def lm_inner(kf_T_cw, lm_pos, edge_active, n_iters):
        """Adaptive-lambda LM with TWO departures from the naive loop:
        (a) the linearization (the dominant cost) is CARRIED
        — one pass per iteration instead of blocks + a separate cost eval;
        (b) a while_loop exits as soon as the step stalls (g2o also stops
        early, optimization_algorithm_levenberg.cpp:89-147) instead of
        burning all n_iters."""
        blocks0 = _ba_cost_and_blocks(prob, kf_T_cw, lm_pos, fx, fy, cx, cy,
                                      bl, edge_active, axis_name)
        lam0 = 1e-5 * jnp.max(jax.vmap(jnp.diag)(blocks0[1]))

        def cond(carry):
            i, T, lp, lam, nu, blocks, stop = carry
            return (i < n_iters) & ~stop

        def body(carry):
            i, T, lp, lam, nu, blocks, stop = carry
            F, Hpp, Hll, Hpl, bp, blm = blocks
            dxp, dxl = _schur_solve(Hpp, Hll, Hpl, bp, blm, lam,
                                    pose_free, lm_free, axis_name)
            T_new = se3.compose(se3.exp(dxp), T)
            lp_new = lp + dxl
            blocks_new = _ba_cost_and_blocks(prob, T_new, lp_new,
                                             fx, fy, cx, cy, bl, edge_active,
                                             axis_name)
            F_new = blocks_new[0]
            pred_l = jnp.sum(dxl * (lam * dxl + blm.T))
            step_l = jnp.max(jnp.abs(dxl))
            finite_l = jnp.all(jnp.isfinite(dxl)).astype(jnp.float32)
            if axis_name is not None:
                pred_l = jax.lax.psum(pred_l, axis_name)
                step_l = jax.lax.pmax(step_l, axis_name)
                # replicate the shard-local finiteness verdict so the accept
                # decision (and the replicated carries it gates) stays
                # consistent across the mesh
                finite_l = jax.lax.pmin(finite_l, axis_name)
            pred = 0.5 * (jnp.sum(dxp * (lam * dxp + bp)) + pred_l)
            rho = (F - F_new) / jnp.maximum(pred, 1e-9)
            finite = jnp.all(jnp.isfinite(dxp)) & (finite_l > 0)
            accept = (rho > 0) & finite
            T = jnp.where(accept, T_new, T)
            lp = jnp.where(accept, lp_new, lp)
            blocks = jax.tree.map(
                lambda n, o: jnp.where(accept, n, o), blocks_new, blocks)
            lam = jnp.where(accept,
                            lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                            lam * nu)
            nu = jnp.where(accept, 2.0, nu * 2.0)
            # converged: the (accepted or damped-to-nothing) step is tiny
            stop = (jnp.maximum(jnp.max(jnp.abs(dxp)), step_l) < 1e-5) \
                & finite
            return i + 1, T, lp, lam, nu, blocks, stop

        _, T, lp, _, _, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), kf_T_cw, lm_pos, lam0,
                         jnp.float32(2.0), blocks0, jnp.asarray(False)))
        return T, lp

    base_active = prob.obs_valid & prob.lm_valid[:, None, None] \
        & prob.kf_valid[None, :, None]

    def round_cond(carry):
        rnd, kf_T_cw, lm_pos, inlier_edges, done = carry
        return (rnd < max_rounds) & ~done

    def round_body(carry):
        rnd, kf_T_cw, lm_pos, inlier_edges, done = carry
        kf_T_cw, lm_pos = lm_inner(kf_T_cw, lm_pos,
                                   base_active & inlier_edges, iters)
        r, _, z_ok = _ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
        chi2 = jnp.sum(r * r, axis=-1)
        inlier_edges = (chi2 < BACKEND_CHI2_TH) & z_ok[..., None]
        n_act = jnp.sum(base_active)
        n_inl = jnp.sum(inlier_edges & base_active)
        if axis_name is not None:
            n_act = jax.lax.psum(n_act, axis_name)
            n_inl = jax.lax.psum(n_inl, axis_name)
        ratio = n_inl / jnp.maximum(n_act, 1)
        done = ratio > target_inlier_ratio
        return rnd + 1, kf_T_cw, lm_pos, inlier_edges, done

    init = (jnp.int32(0), prob.kf_T_cw, prob.lm_pos,
            jnp.ones_like(prob.obs_valid), jnp.asarray(False))
    _, kf_T_cw, lm_pos, inlier_edges, _ = jax.lax.while_loop(
        round_cond, round_body, init)

    r, _, z_ok = _ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
    chi2 = jnp.sum(r * r, axis=-1)
    final_inlier = (chi2 < BACKEND_CHI2_TH) & z_ok[..., None]
    obs_valid = prob.obs_valid & final_inlier
    n_act = jnp.sum(base_active)
    n_inl = jnp.sum(final_inlier & base_active)
    if axis_name is not None:
        n_act = jax.lax.psum(n_act, axis_name)
        n_inl = jax.lax.psum(n_inl, axis_name)
    ratio = n_inl / jnp.maximum(n_act, 1)
    return LocalBAResult(kf_T_cw, lm_pos, obs_valid, chi2,
                         ratio.astype(jnp.float32))

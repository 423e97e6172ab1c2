"""Batched RANSAC PnP (3D->2D absolute pose).

Capability parity with the reference's cv::solvePnPRansac usage in loop
closing (reference src/ssvio/loopclosing.cpp:196-215: 100 iterations,
reprojection threshold 5.991 px, conf 0.99) followed by pose-only
refinement (OptimizeCurrentPose, loopclosing.cpp:245-351).

All RANSAC hypotheses run SIMULTANEOUSLY — one vmapped 6-point
DLT (12x12 eigen-problem per hypothesis) + a dense [hyp, N] reprojection
inlier count, then the best hypothesis is refined with the batched
pose-only LM from ops/ba. No data-dependent loop, one jit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssvio_tpu.ops import ba, se3


class PnPResult(NamedTuple):
    T_cw: jnp.ndarray       # [3, 4]
    inlier: jnp.ndarray     # [N] bool
    n_inliers: jnp.ndarray  # [] int32
    ok: jnp.ndarray         # [] bool — enough inliers to trust the pose


def _dlt_pose(p_w: jnp.ndarray, xn: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted DLT for T_cw from >=6 3D-2D pairs in NORMALIZED image coords.

    p_w [K, 3], xn [K, 2], w [K] weights. Returns T_cw [3, 4].

    Hartley-normalizes both point sets first — the minimal 6-point system is
    numerically marginal in float32 without it (the engine runs float32).
    """
    K = p_w.shape[0]
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    # --- normalize 3D: zero centroid, RMS radius sqrt(3)
    c3 = jnp.sum(p_w * w[:, None], axis=0) / wsum
    Xc = p_w - c3
    s3 = jnp.sqrt(jnp.sum(w * jnp.sum(Xc * Xc, axis=1)) / wsum / 3.0)
    s3 = jnp.maximum(s3, 1e-9)
    Xn3 = Xc / s3
    # --- normalize 2D: zero centroid, RMS radius sqrt(2)
    c2 = jnp.sum(xn * w[:, None], axis=0) / wsum
    xc = xn - c2
    s2 = jnp.sqrt(jnp.sum(w * jnp.sum(xc * xc, axis=1)) / wsum / 2.0)
    s2 = jnp.maximum(s2, 1e-9)
    xn2 = xc / s2

    X = jnp.concatenate([Xn3, jnp.ones((K, 1), p_w.dtype)], axis=1)   # [K,4]
    zero = jnp.zeros_like(X)
    # rows: [X 0 -x*X ; 0 X -y*X]
    r0 = jnp.concatenate([X, zero, -xn2[:, 0:1] * X], axis=1)         # [K,12]
    r1 = jnp.concatenate([zero, X, -xn2[:, 1:2] * X], axis=1)
    A = jnp.concatenate([r0 * w[:, None], r1 * w[:, None]], axis=0)   # [2K,12]
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    pn = vecs[:, 0].reshape(3, 4)
    # denormalize: P = T2^-1 @ Pn @ T3, with
    # T2^-1 = [[s2,0,c2x],[0,s2,c2y],[0,0,1]], T3 = [[I/s3, -c3/s3],[0,1]]
    T2inv = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                      p_w.dtype)
    T2inv = T2inv.at[0, 0].set(s2).at[1, 1].set(s2) \
                 .at[0, 2].set(c2[0]).at[1, 2].set(c2[1])
    T3 = jnp.concatenate([jnp.eye(3, dtype=p_w.dtype) / s3,
                          (-c3 / s3)[:, None]], axis=1)
    T3 = jnp.concatenate([T3, jnp.array([[0.0, 0.0, 0.0, 1.0]], p_w.dtype)],
                         axis=0)
    p = T2inv @ pn @ T3
    # the eigenvector is defined up to sign: P = alpha [R|t]. det(M) =
    # alpha^3, so flipping by sign(det) makes the remaining scale positive —
    # only then does SVD orthogonalization recover the true rotation.
    M = p[:, :3]
    sgn = jnp.where(jnp.linalg.det(M) < 0, -1.0, 1.0)
    M = M * sgn
    p4 = p[:, 3] * sgn
    u, s, vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(u @ vt)
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det])
    R = (u * d[None, :]) @ vt
    scale = jnp.maximum(jnp.mean(s), 1e-12)
    t = p4 / scale
    return se3.make(R, t)


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "sample_size",
                                              "min_inliers"))
def pnp_ransac(p_w: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
               fx, fy, cx, cy, key: jax.Array,
               n_hypotheses: int = 128, sample_size: int = 6,
               reproj_threshold: float = 5.991,
               min_inliers: int = 10) -> PnPResult:
    """RANSAC + DLT + pose-only-LM refinement.

    `min_inliers` mirrors the reference's >=10 gate
    (loopclosing.cpp:216-219 / 340-349).
    """
    N = p_w.shape[0]
    xn = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], axis=-1)

    # sample hypotheses WITHOUT replacement per hypothesis (Gumbel top-k):
    # duplicated points would make the 11-dof DLT underdetermined.
    logits = jnp.where(valid, 0.0, -1e9)
    gumbel = jax.random.gumbel(key, (n_hypotheses, N))
    _, idx = jax.lax.top_k(gumbel + logits[None, :], sample_size)
    samp_pw = p_w[idx]                        # [H, S, 3]
    samp_xn = xn[idx]
    samp_w = jnp.ones((n_hypotheses, sample_size), p_w.dtype)

    T_hyp = jax.vmap(_dlt_pose)(samp_pw, samp_xn, samp_w)   # [H, 3, 4]
    # Gauss-Newton polish of each hypothesis on its own sample points: the
    # raw minimal DLT amplifies pixel noise badly; a few LM steps on the 6
    # points recovers it (this is what cv2's RANSAC does per sample too).
    samp_uv = uv[idx]
    T_hyp = jax.vmap(
        lambda T, pw, puv: ba._lm_loop_6dof(
            T, pw, puv, jnp.ones(sample_size, p_w.dtype), fx, fy, cx, cy, 5)
    )(T_hyp, samp_pw, samp_uv)

    def score(T):
        r, _, z_ok = ba.reproject_residual(T[:, None], p_w[None], uv[None],
                                           fx, fy, cx, cy)
        err2 = jnp.sum(r * r, axis=-1)                      # [H, N]
        inl = (err2 < reproj_threshold ** 2) & z_ok & valid[None]
        finite = jnp.all(jnp.isfinite(T.reshape(T.shape[0], -1)), axis=1)
        return inl, jnp.where(finite, jnp.sum(inl, axis=1), -1)

    inl, scores = score(T_hyp)

    # LO-RANSAC: re-fit EVERY hypothesis on all of its inliers (non-minimal
    # weighted DLT, still one batched pass), keep whichever scores better.
    w_lo = inl.astype(p_w.dtype) * (scores >= sample_size)[:, None]
    T_lo = jax.vmap(_dlt_pose, in_axes=(None, None, 0))(p_w, xn, w_lo)
    inl_lo, scores_lo = score(T_lo)
    better = scores_lo > scores
    T_all = jnp.where(better[:, None, None], T_lo, T_hyp)
    inl = jnp.where(better[:, None], inl_lo, inl)
    scores = jnp.maximum(scores, scores_lo)

    best = jnp.argmax(scores)
    T_best = T_all[best]
    inlier0 = inl[best]

    # refine on RANSAC inliers with the 4x10 pose-only LM
    res = ba.pose_only_optimize(T_best, p_w, uv, inlier0, fx, fy, cx, cy)
    ok = (res.n_inliers >= min_inliers) & (scores[best] >= sample_size)
    return PnPResult(res.T_cw, res.inlier, res.n_inliers, ok)

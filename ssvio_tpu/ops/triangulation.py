"""Batched multi-view linear (DLT) triangulation.

Capability parity with the reference's SVD triangulation
(reference include/ssvio/algorithm.hpp:23-45): solve the 2N x 4 DLT system
per landmark by SVD, keep the solution only when the quality gate
sigma3/sigma2 < 1e-2 holds, and (at call sites) require positive depth.

The whole landmark batch is one `jnp.linalg.svd` over [B, 4, 4]
normal matrices (A^T A instead of the rectangular A — same right singular
vectors, fixed shape regardless of view count, and the 4x4 eigen-problem is
far cheaper than the 2Nx4 SVD).

For the dominant rectified two-view case we also provide the closed-form
disparity triangulation (pure elementwise math).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def triangulate_dlt(proj: jnp.ndarray, uv_norm: jnp.ndarray,
                    valid: jnp.ndarray | None = None,
                    sv_ratio_gate: float = 1e-2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """DLT triangulation from V views per landmark.

    Args:
      proj:    [..., V, 3, 4] pose matrices T_cw (normalized cameras: rows are
               used directly, matching reference algorithm.hpp which feeds
               `pose.matrix3x4()` and normalized image points).
      uv_norm: [..., V, 2] normalized image coordinates (x/z, y/z).
      valid:   [..., V] bool mask of usable views (None = all valid).

    Returns:
      (p_w [..., 3], ok [...]) where ok = quality gate passed
      (sigma3/sigma2 < sv_ratio_gate, reference algorithm.hpp:40-44).
    """
    # rows: x * P[2] - P[0],  y * P[2] - P[1]
    r0 = uv_norm[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]   # [..., V, 4]
    r1 = uv_norm[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    A = jnp.concatenate([r0, r1], axis=-2)                        # [..., 2V, 4]
    if valid is not None:
        w = jnp.repeat(valid.astype(A.dtype), 2, axis=-1)[..., None]
        A = A * w
    # 4x4 normal matrix; eigvec of smallest eigenvalue == smallest right SV.
    AtA = jnp.swapaxes(A, -1, -2) @ A                             # [..., 4, 4]
    # eigh returns ascending eigenvalues.
    evals, evecs = jnp.linalg.eigh(AtA)
    x = evecs[..., :, 0]                                          # [..., 4]
    w_h = x[..., 3]
    safe_w = jnp.where(jnp.abs(w_h) < 1e-12, 1e-12, w_h)
    p = x[..., :3] / safe_w[..., None]
    # singular values of A = sqrt(eigvals of AtA); gate sigma3/sigma2 < eps
    # (ascending: evals[0]<=...<=evals[3]; sigma3 is 2nd smallest? reference
    # uses svd descending sigma[3]/sigma[2] < 1e-2, i.e. smallest/2nd-smallest)
    s_small = jnp.sqrt(jnp.maximum(evals[..., 0], 0.0))
    s_next = jnp.sqrt(jnp.maximum(evals[..., 1], 0.0))
    s_big = jnp.sqrt(jnp.maximum(evals[..., 3], 1e-20))
    # A degenerate ray configuration (e.g. zero baseline) has a >=2-D
    # nullspace: sigma2 collapses too, so the plain sigma3/sigma2 ratio is
    # 0/0. Demand a healthy sigma2 as well.
    well_posed = s_next > 1e-4 * s_big
    ok = well_posed & (s_small < sv_ratio_gate * jnp.maximum(s_next, 1e-20))
    return p, ok


def triangulate_stereo_rectified(uv_l: jnp.ndarray, uv_r: jnp.ndarray,
                                 fx: jnp.ndarray, fy: jnp.ndarray,
                                 cx: jnp.ndarray, cy: jnp.ndarray,
                                 baseline: jnp.ndarray,
                                 min_disparity: float = 0.1):
    """Closed-form rectified two-view triangulation in the LEFT camera frame.

    z = fx * b / disparity. Purely elementwise: the fast path used during
    keyframe creation (reference triangulates the same stereo pair through
    the generic SVD path; the closed form is algebraically identical for a
    rectified pair and is elementwise).

    Returns (p_cam [..., 3], ok [...]).
    """
    disp = uv_l[..., 0] - uv_r[..., 0]
    ok = disp > min_disparity
    safe_disp = jnp.where(ok, disp, 1.0)
    z = fx * baseline / safe_disp
    x = (uv_l[..., 0] - cx) / fx * z
    y = (uv_l[..., 1] - cy) / fy * z
    p = jnp.stack([x, y, z], axis=-1)
    return p, ok

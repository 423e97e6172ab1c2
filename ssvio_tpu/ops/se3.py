"""SO(3)/SE(3) Lie-group operations, fully batched / vmappable.

Capability parity with the Sophus usage in the reference (vendored
thirdparty/sophus; used e.g. reference src/ssvio/frontend.cpp:552,
include/ssvio/g2otypes.hpp:40,175): exp/log maps, compose, inverse, action
on points. Poses are plain `[..., 3, 4]` float arrays
(`[R | t]`), every op broadcasts over leading batch dims, and all series
expansions use Taylor fallbacks guarded by `jnp.where` so they jit with no
data-dependent branching.

Twist ordering: `xi = [rho(3), phi(3)]` (translation first, rotation second),
matching Sophus' SE3 tangent convention so magnitude thresholds in the loop
closer (reference src/ssvio/loopclosing.cpp:224-234: accept if
1 < ||log(delta)|| < 15) transfer unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-8


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] skew -> [..., 3]."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula with Taylor fallback near 0. [...,3] -> [...,3,3]."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta < 1e-5
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3]. Handles theta near 0 and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # Generic branch: vee((R - R^T)/2) * theta/sin(theta)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5
    small = theta < 1e-5
    sin_t = jnp.sin(theta)
    scale = jnp.where(small, 1.0 + theta * theta / 6.0,
                      theta / jnp.where(small, 1.0, sin_t))
    generic = w * scale[..., None]
    # Near pi: R ~ I + 2 K^2/theta^2... use axis from diagonal of (R+I)/2.
    near_pi = theta > 3.0
    # axis^2 proportional to diag((R + I)) / 2 elementwise
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    axis = jnp.sqrt(axis2)
    # fix signs using off-diagonal sums: sign of axis_i from (w approx) or
    # products R[i,j]+R[j,i] = 2 a_i a_j (1-cos) -> sign(a_i a_j)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    # choose the largest axis component as reference positive, derive others
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    x_big = (ax >= ay) & (ax >= az)
    y_big = (~x_big) & (ay >= az)
    sign = lambda v: jnp.where(v >= 0, 1.0, -1.0)
    # if x largest: ax>0, ay = sign(sxy)*|ay|, az = sign(sxz)*|az|
    cand_x = jnp.stack([ax, sign(sxy) * ay, sign(sxz) * az], axis=-1)
    cand_y = jnp.stack([sign(sxy) * ax, ay, sign(syz) * az], axis=-1)
    cand_z = jnp.stack([sign(sxz) * ax, sign(syz) * ay, az], axis=-1)
    axis_signed = jnp.where(x_big[..., None], cand_x,
                            jnp.where(y_big[..., None], cand_y, cand_z))
    near_pi_val = axis_signed * theta[..., None]
    # align near-pi sign with the (tiny but direction-preserving) w
    flip = jnp.sum(near_pi_val * w, axis=-1, keepdims=True) < 0
    near_pi_val = jnp.where(flip, -near_pi_val, near_pi_val)
    return jnp.where(near_pi[..., None], near_pi_val, generic)


# ---------------------------------------------------------------------------
# SE(3): pose stored as [..., 3, 4] = [R | t], mapping points by R p + t.
# ---------------------------------------------------------------------------

def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    T = jnp.concatenate([jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype=dtype)], axis=1)
    return jnp.broadcast_to(T, (*batch_shape, 3, 4))


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([R, t[..., None]], axis=-1)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B as SE3: (Ra Rb, Ra tb + ta)."""
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    R = Ra @ Rb
    t = jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return make(R, t)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R, t = rotation(T), translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply pose to points. T [...,3,4], p [...,3] -> [...,3]."""
    return jnp.einsum("...ij,...j->...i", rotation(T), p) + translation(T)


# ----------------------------------------------------------------------
# Host-side (NumPy) variants for bookkeeping on small per-keyframe records.
# A device round trip on this link costs ~29 ms, so composing two 3x4
# matrices through jnp in a host loop is ~1000x slower than doing it here.
# ----------------------------------------------------------------------

def compose_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A @ B as SE3 on host numpy arrays ([..., 3, 4])."""
    A = np.asarray(A)
    B = np.asarray(B)
    out = np.empty(np.broadcast_shapes(A.shape, B.shape), A.dtype)
    out[..., :3] = A[..., :3] @ B[..., :3]
    out[..., 3] = np.einsum("...ij,...j->...i", A[..., :3], B[..., 3]) + A[..., 3]
    return out


def inverse_np(T: np.ndarray) -> np.ndarray:
    """SE3 inverse on host numpy arrays ([..., 3, 4])."""
    T = np.asarray(T)
    Rt = np.swapaxes(T[..., :3], -1, -2)
    out = np.empty_like(T)
    out[..., :3] = Rt
    out[..., 3] = -np.einsum("...ij,...j->...i", Rt, T[..., 3])
    return out


def _so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """V matrix in se3 exp: p-part = V rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta < 1e-5
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / jnp.where(small, 1.0, theta2 * theta))
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta < 1e-5
    half = theta * 0.5
    # cot coefficient: (1 - theta/2 * cot(theta/2)) / theta^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half)))
        / jnp.where(small, 1.0, theta2),
    )
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term[..., None, None] * (K @ K)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se3 exp. xi [..., 6] = [rho, phi] -> [..., 3, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return make(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """se3 log. [..., 3, 4] -> [..., 6] = [rho, phi]."""
    phi = so3_log(rotation(T))
    Vinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, translation(T))
    return jnp.concatenate([rho, phi], axis=-1)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint matrix [..., 6, 6] for [rho, phi] ordering:
    Ad = [[R, hat(t) R], [0, R]]."""
    R, t = rotation(T), translation(T)
    tR = hat(t) @ R
    zeros = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def normalize_rotation(T: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize R via SVD (drift control after many composes)."""
    R, t = rotation(T), translation(T)
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    d = jnp.ones_like(det)
    fix = jnp.stack([d, d, det], axis=-1)
    Rn = (u * fix[..., None, :]) @ vt
    return make(Rn, t)


# ---------------------------------------------------------------------------
# Quaternion interop (for TUM export; w-last xyzw like TUM/ROS)
# ---------------------------------------------------------------------------

def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 4] quaternion (x, y, z, w), branch-free (Shepperd
    method via 4-candidate select)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # candidate squared norms *4
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = jnp.stack([qx2, qy2, qz2, qw2], axis=-1)
    idx = jnp.argmax(cands, axis=-1)
    s_w = jnp.sqrt(jnp.maximum(qw2, 1e-12)) * 2.0
    s_x = jnp.sqrt(jnp.maximum(qx2, 1e-12)) * 2.0
    s_y = jnp.sqrt(jnp.maximum(qy2, 1e-12)) * 2.0
    s_z = jnp.sqrt(jnp.maximum(qz2, 1e-12)) * 2.0
    q_w = jnp.stack([(m21 - m12) / s_w, (m02 - m20) / s_w, (m10 - m01) / s_w, s_w / 4.0], axis=-1)
    q_x = jnp.stack([s_x / 4.0, (m01 + m10) / s_x, (m02 + m20) / s_x, (m21 - m12) / s_x], axis=-1)
    q_y = jnp.stack([(m01 + m10) / s_y, s_y / 4.0, (m12 + m21) / s_y, (m02 - m20) / s_y], axis=-1)
    q_z = jnp.stack([(m02 + m20) / s_z, (m12 + m21) / s_z, s_z / 4.0, (m10 - m01) / s_z], axis=-1)
    stacked = jnp.stack([q_x, q_y, q_z, q_w], axis=-2)  # [..., 4cand, 4comp]
    q = jnp.take_along_axis(stacked, idx[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    # canonical sign: w >= 0
    q = jnp.where(q[..., 3:4] < 0, -q, q)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] (x,y,z,w) -> [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    r1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    r2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([r0, r1, r2], axis=-2)

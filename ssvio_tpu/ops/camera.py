"""Pinhole stereo camera model — batched projective ops.

Capability parity with the reference's Camera class
(reference src/ssvio/camera.cpp:9-55, include/ssvio/camera.hpp:21-36):
world<->camera<->pixel transforms for a rectified pinhole pair with an SE3
extrinsic per eye, plus undistortion. Everything broadcasts over leading
batch dims and jits cleanly.

The stereo extrinsic convention follows the reference's construction
(reference src/ssvio/system.cpp:54-113): the left camera frame IS the body
frame (identity extrinsic); the right camera sits at a pure baseline
translation `t = [-b, 0, 0]` applied in camera coords, i.e.
`p_right = p_left + [-b, 0, 0]`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ssvio_tpu.ops import se3


class Intrinsics(NamedTuple):
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @property
    def K(self) -> jnp.ndarray:
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack([
            jnp.stack([fx, z, cx], axis=-1),
            jnp.stack([z, fy, cy], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ], axis=-2)


class StereoRig(NamedTuple):
    """Static description of the rectified stereo pair."""
    intr_left: Intrinsics
    intr_right: Intrinsics
    baseline: jnp.ndarray    # metres; right cam at [-b,0,0] in left frame

    @classmethod
    def from_settings(cls, s) -> "StereoRig":
        f32 = lambda v: jnp.float32(v)
        il = Intrinsics(f32(s.cam_left.fx), f32(s.cam_left.fy),
                        f32(s.cam_left.cx), f32(s.cam_left.cy))
        ir = Intrinsics(f32(s.cam_right.fx), f32(s.cam_right.fy),
                        f32(s.cam_right.cx), f32(s.cam_right.cy))
        return cls(il, ir, f32(s.baseline))


# --- projective ops (mirror reference camera.cpp:9-41 semantics) -----------

def camera2pixel(intr: Intrinsics, p_c: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] camera coords -> [..., 2] pixels. No z clamp; callers mask."""
    z = p_c[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = intr.fx * p_c[..., 0] / safe_z + intr.cx
    v = intr.fy * p_c[..., 1] / safe_z + intr.cy
    return jnp.stack([u, v], axis=-1)


def pixel2camera(intr: Intrinsics, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """[..., 2] pixels + [...] depth -> [..., 3] camera coords."""
    x = (uv[..., 0] - intr.cx) / intr.fx * depth
    y = (uv[..., 1] - intr.cy) / intr.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def world2camera(T_cw: jnp.ndarray, p_w: jnp.ndarray) -> jnp.ndarray:
    return se3.transform(T_cw, p_w)


def camera2world(T_cw: jnp.ndarray, p_c: jnp.ndarray) -> jnp.ndarray:
    return se3.transform(se3.inverse(T_cw), p_c)


def world2pixel(intr: Intrinsics, T_cw: jnp.ndarray, p_w: jnp.ndarray) -> jnp.ndarray:
    return camera2pixel(intr, world2camera(T_cw, p_w))


def right_from_left_cam(rig: StereoRig, p_cl: jnp.ndarray) -> jnp.ndarray:
    """Left-camera coords -> right-camera coords (rectified pair)."""
    offset = jnp.stack([-rig.baseline, jnp.zeros_like(rig.baseline),
                        jnp.zeros_like(rig.baseline)], axis=-1)
    return p_cl + offset


def stereo_project(rig: StereoRig, T_cw: jnp.ndarray, p_w: jnp.ndarray):
    """Project world points into both eyes. Returns (uv_l, uv_r, z_left)."""
    p_cl = world2camera(T_cw, p_w)
    uv_l = camera2pixel(rig.intr_left, p_cl)
    uv_r = camera2pixel(rig.intr_right, right_from_left_cam(rig, p_cl))
    return uv_l, uv_r, p_cl[..., 2]


def undistort_points(intr: Intrinsics, dist, uv: jnp.ndarray,
                     iters: int = 5) -> jnp.ndarray:
    """Iterative plumb-bob undistortion of pixel points (k1,k2,p1,p2).

    Capability parity with the reference's image-space undistortion
    (reference src/ssvio/camera.cpp:43-55) expressed point-wise — a
    pipeline that undistorts keypoints, not whole images, drops the per
    -frame image warp disappears from the hot path. KITTI is rectified
    (all coefficients 0) so this is exercised only when configured.
    """
    k1, k2, p1, p2 = dist
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    u = x * intr.fx + intr.cx
    v = y * intr.fy + intr.cy
    return jnp.stack([u, v], axis=-1)


def distort_normalized(dist, x: jnp.ndarray, y: jnp.ndarray):
    """Forward plumb-bob distortion of normalized coords (k1,k2,p1,p2)."""
    k1, k2, p1, p2 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_image(intr: Intrinsics, dist, img: jnp.ndarray) -> jnp.ndarray:
    """Whole-image undistortion (reference Camera::UndistortImage,
    src/ssvio/camera.cpp:43-55, which wraps cv::undistort).

    The remap grid is a pure function of the (static)
    intrinsics, so XLA constant-folds it; the resample is one bilinear
    gather pass over the image. The tracking pipeline itself prefers
    `undistort_points` (keypoint-space, no per-frame warp); this op exists
    for capability parity and for consumers that need rectified imagery
    (e.g. the viewer or descriptor sampling on heavily distorted lenses).
    """
    h, w = img.shape
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    # output pixel -> normalized ideal coords -> distorted source pixel
    xn = (xx - intr.cx) / intr.fx
    yn = (yy - intr.cy) / intr.fy
    xn, yn = jnp.broadcast_to(xn, (h, w)), jnp.broadcast_to(yn, (h, w))
    xd, yd = distort_normalized(dist, xn, yn)
    u = xd * intr.fx + intr.cx
    v = yd * intr.fy + intr.cy
    u = jnp.clip(u, 0.0, w - 1.0)
    v = jnp.clip(v, 0.0, h - 1.0)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, w - 1)
    v1 = jnp.minimum(v0 + 1, h - 1)
    fu = u - u0
    fv = v - v0
    g = lambda vi, ui: img[vi, ui]
    top = g(v0, u0) * (1 - fu) + g(v0, u1) * fu
    bot = g(v1, u0) * (1 - fu) + g(v1, u1) * fu
    return top * (1 - fv) + bot * fv

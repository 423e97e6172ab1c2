"""Pyramidal Lucas-Kanade optical flow, batched over keypoints.

Capability parity with the reference's cv::calcOpticalFlowPyrLK usage
(reference src/ssvio/frontend.cpp:156-166 and :374-384): 11x11 window,
3 pyramid levels, up to 30 iterations, eps 0.01, WITH initial-flow seeding
(OPTFLOW_USE_INITIAL_FLOW — the constant-velocity / projection prior is the
start point at the finest level).

The KLT window moves as a rigid translation, so every sample in the
window shares one fractional offset. The XLA reference below therefore
extracts, per level, one fixed-size patch per keypoint (a vmapped
`lax.dynamic_slice`) and samples each iteration's 11x11 window as one
dynamic slice of that patch plus a 4-corner bilinear blend with scalar
weights. Convergence uses a freeze mask inside `lax.fori_loop`; shapes are
static everywhere. The spatial-gradient matrix G comes from the template
window and stays fixed across iterations (classic forward-additive KLT, as
in OpenCV).

On a GPU each level runs instead as one Pallas kernel
(`ops/lk_triton.py`) with a per-keypoint early exit; the XLA path stays
its reference and runs on every other platform. The platform alone
chooses.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from jax import lax

from ssvio_tpu.ops import pyramid as pyr_ops
from ssvio_tpu.ops import sampling


class LKParams(NamedTuple):
    window: int = 11
    levels: int = 3
    iters: int = 30
    eps: float = 0.01
    min_eig: float = 1e-4     # per-pixel min eigenvalue threshold (OpenCV-like)
    margin: int = 8           # search slack around the seed per level (px)


def _platform_impl() -> str:
    """The level implementation for the default backend."""
    return "kernel" if jax.default_backend() == "gpu" else "xla"


def _extract_patches(img: jnp.ndarray, top_left: jnp.ndarray, size: int):
    """Vmapped dynamic-slice patch extraction.

    top_left: [N, 2] INTEGER (x, y). Returns (patches [N, size, size],
    actual_top_left [N, 2]) — lax.dynamic_slice clamps at borders, so the
    clamped origin is returned for correct local coordinates.
    """
    h, w = img.shape
    x0 = jnp.clip(top_left[:, 0], 0, w - size)
    y0 = jnp.clip(top_left[:, 1], 0, h - size)

    def one(y, x):
        return lax.dynamic_slice(img, (y, x), (size, size))

    patches = jax.vmap(one)(y0, x0)
    return patches, jnp.stack([x0, y0], axis=-1)


def _sample_window(patches: jnp.ndarray, local_tl: jnp.ndarray, win: int):
    """Bilinear window sample from per-keypoint patches.

    patches: [N, P, P]; local_tl: [N, 2] float window top-left in patch
    coords. Returns [N, win, win]. One dynamic slice + 4-corner scalar blend
    per keypoint (vmapped) — no element gathers.
    """
    Pp = patches.shape[-1]
    base_x = jnp.clip(jnp.floor(local_tl[:, 0]), 0, Pp - win - 1)
    base_y = jnp.clip(jnp.floor(local_tl[:, 1]), 0, Pp - win - 1)
    fx = (local_tl[:, 0] - base_x)[:, None, None]
    fy = (local_tl[:, 1] - base_y)[:, None, None]

    def one(patch, y, x):
        return lax.dynamic_slice(patch, (y, x), (win + 1, win + 1))

    s = jax.vmap(one)(patches, base_y.astype(jnp.int32), base_x.astype(jnp.int32))
    return ((1 - fy) * (1 - fx) * s[:, :win, :win]
            + (1 - fy) * fx * s[:, :win, 1:win + 1]
            + fy * (1 - fx) * s[:, 1:win + 1, :win]
            + fy * fx * s[:, 1:win + 1, 1:win + 1])


def _track_level_kernel(img_prev, img_cur, gx, gy, pts_prev, pts_guess,
                        valid, params: LKParams, interpret: bool = False):
    """`_track_level` through the GPU kernel (same outputs)."""
    from ssvio_tpu.ops import lk_triton

    h, w = img_cur.shape
    pts_out, good = lk_triton.track_level(
        img_prev, img_cur, gx, gy, pts_prev, pts_guess, valid,
        window=params.window, margin=params.margin, iters=params.iters,
        eps=params.eps, min_eig=params.min_eig, interpret=interpret)
    ok = good & sampling.in_bounds(pts_out, h, w, border=1.0) \
        & sampling.in_bounds(pts_prev, img_prev.shape[0], img_prev.shape[1],
                             border=1.0)
    return pts_out, ok


def _track_level(img_prev: jnp.ndarray, img_cur: jnp.ndarray,
                 gx: jnp.ndarray, gy: jnp.ndarray,
                 pts_prev: jnp.ndarray, pts_guess: jnp.ndarray,
                 valid: jnp.ndarray,
                 params: LKParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One pyramid level of KLT. Returns (pts_cur [N,2], ok [N]).

    `valid` pre-freezes dead keypoints: invalid slots of the fixed-capacity
    feature array would otherwise burn full iteration loops on stale
    positions (typically ~half the slots in steady state)."""
    win = params.window
    r = win // 2
    margin = params.margin
    h, w = img_cur.shape
    Pt = win + 2                      # template patch (fixed position)
    # search patch, capped so it fits the (possibly tiny coarse) level
    Pc = min(win + 2 * margin + 2, h, w)

    # --- template + gradient windows at the (fractional) prev position
    tl_prev_i = jnp.floor(pts_prev).astype(jnp.int32) - r
    patch_T, org_T = _extract_patches(img_prev, tl_prev_i, Pt)
    patch_gx, _ = _extract_patches(gx, tl_prev_i, Pt)
    patch_gy, _ = _extract_patches(gy, tl_prev_i, Pt)
    local_T = pts_prev - r - org_T.astype(pts_prev.dtype)
    T = _sample_window(patch_T, local_T, win)
    Gx = _sample_window(patch_gx, local_T, win)
    Gy = _sample_window(patch_gy, local_T, win)

    gxx = jnp.sum(Gx * Gx, axis=(1, 2))
    gxy = jnp.sum(Gx * Gy, axis=(1, 2))
    gyy = jnp.sum(Gy * Gy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) * 0.5
    good_g = (min_eig / (win * win)) > params.min_eig
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)

    # --- current-image search patches around the integer seed
    tl_cur_i = jnp.round(pts_guess).astype(jnp.int32) - (r + margin)
    patch_C, org_C = _extract_patches(img_cur, tl_cur_i, Pc)
    org_Cf = org_C.astype(pts_guess.dtype)

    def body(_, carry):
        pts, frozen = carry
        local_tl = pts - r - org_Cf                     # window TL in patch
        I = _sample_window(patch_C, local_tl, win)
        diff = T - I
        bx = jnp.sum(diff * Gx, axis=(1, 2))
        by = jnp.sum(diff * Gy, axis=(1, 2))
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (gxx * by - gxy * bx) * inv_det
        delta = jnp.stack([dx, dy], axis=-1)
        step = jnp.where((frozen | ~good_g)[:, None], 0.0, delta)
        new_pts = pts + step
        converged = jnp.sum(delta * delta, axis=-1) < params.eps ** 2
        # leaving the search patch (or the image) freezes the point
        new_local = new_pts - r - org_Cf
        oob = ((new_local[:, 0] < 0) | (new_local[:, 1] < 0)
               | (new_local[:, 0] > Pc - win - 1)
               | (new_local[:, 1] > Pc - win - 1)
               | ~sampling.in_bounds(new_pts, h, w, border=r + 1))
        return new_pts, frozen | converged | oob

    pts0 = pts_guess
    local0 = pts0 - r - org_Cf
    frozen0 = (~valid | (local0[:, 0] < 0) | (local0[:, 1] < 0)
               | (local0[:, 0] > Pc - win - 1) | (local0[:, 1] > Pc - win - 1)
               | ~sampling.in_bounds(pts0, h, w, border=r + 1))
    pts_out, _ = lax.fori_loop(0, params.iters, body, (pts0, frozen0))
    ok = good_g & sampling.in_bounds(pts_out, h, w, border=1.0) \
        & sampling.in_bounds(pts_prev, img_prev.shape[0], img_prev.shape[1],
                             border=1.0)
    return pts_out, ok


def track(pyr_prev: List[jnp.ndarray], pyr_cur: List[jnp.ndarray],
          pts_prev: jnp.ndarray, pts_init: jnp.ndarray,
          valid: jnp.ndarray, params: LKParams = LKParams(),
          compute_err: bool = True, grads_prev=None, _impl: str | None = None
          ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Track keypoints from prev to cur through the pyramid.

    Args:
      pyr_prev/pyr_cur: power-of-two pyramids (finest first), see
        pyramid.build_lk_pyramid.
      pts_prev: [N, 2] positions in the prev frame (finest level coords).
      pts_init: [N, 2] initial guesses in cur frame (the USE_INITIAL_FLOW
        seed; pass pts_prev for none).
      valid:    [N] input validity mask.
      compute_err: when False, skip the final photometric window resample —
        it is a vmapped-dynamic-slice gather pass, and only callers that
        gate on `err` need it
        (the stereo matcher; the temporal tracker uses the FB check
        instead). err is returned as zeros in that case.
      grads_prev: optional ((gx per level), (gy per level)) Sobel gradients
        of pyr_prev, computed once per image and reused across the
        forward/backward/stereo track calls that share a template pyramid
        None recomputes them here.
      _impl: private. 'xla', 'kernel' or 'interpret' (the kernel in the
        Pallas interpreter) overrides the platform's choice; for tests and
        the on-card comparison, never a setting.

    Returns (pts_cur [N, 2], ok [N] bool, err [N] mean abs window residual).
    """
    levels = min(params.levels, len(pyr_prev))
    flow = (pts_init - pts_prev) / (2.0 ** (levels - 1))
    pts_lvl = pts_prev / (2.0 ** (levels - 1))
    impl = _impl or _platform_impl()
    if impl == "xla":
        level_fn = _track_level
    else:
        level_fn = functools.partial(_track_level_kernel,
                                     interpret=(impl == "interpret"))
    ok = valid
    for l in range(levels - 1, -1, -1):
        img_p = pyr_prev[l]
        img_c = pyr_cur[l]
        if grads_prev is not None:
            gx, gy = grads_prev[0][l], grads_prev[1][l]
        else:
            gx, gy = pyr_ops.sobel_gradients(img_p)
        pts_cur_lvl, ok_lvl = level_fn(img_p, img_c, gx, gy, pts_lvl,
                                       pts_lvl + flow, valid, params)
        flow = pts_cur_lvl - pts_lvl
        ok = ok & ok_lvl
        if l > 0:
            pts_lvl = pts_prev / (2.0 ** (l - 1))
            flow = flow * 2.0
    pts_cur = pts_prev + flow
    if compute_err:
        # final photometric error on the finest level (window resample)
        win = params.window
        r = win // 2
        tlp = jnp.floor(pts_prev).astype(jnp.int32) - r
        patch_T, org_T = _extract_patches(pyr_prev[0], tlp, win + 2)
        T = _sample_window(patch_T, pts_prev - r - org_T.astype(pts_prev.dtype),
                           win)
        tlc = jnp.floor(pts_cur).astype(jnp.int32) - r
        patch_I, org_I = _extract_patches(pyr_cur[0], tlc, win + 2)
        I = _sample_window(patch_I, pts_cur - r - org_I.astype(pts_cur.dtype),
                           win)
        err = jnp.mean(jnp.abs(T - I), axis=(1, 2))
    else:
        err = jnp.zeros(pts_cur.shape[0], pts_cur.dtype)
    ok = ok & sampling.in_bounds(pts_cur, pyr_cur[0].shape[0], pyr_cur[0].shape[1],
                                 border=1.0)
    return pts_cur, ok, err

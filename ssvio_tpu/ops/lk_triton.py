"""One pyramid level of KLT as a Pallas kernel for the Triton GPU route.

Same contract and arithmetic as the XLA reference `lk._track_level`:
forward-additive KLT with the template, its gradients and the 2x2 G matrix
fixed, a bilinear window whose samples share one fractional offset, and a
keypoint that freezes once its step drops below `eps`, its window leaves
the search patch, or the window leaves the image.

What the kernel changes is how that runs on the card. XLA compiles the
reference's `fori_loop` as one launch per iteration over all keypoints,
with no early exit. Here each program owns GROUP keypoints (one: other
group sizes and warp counts measured no faster on an H100) and loops over
its own iterations in a `while_loop` that ends when all of them have
frozen. The template and gradient windows stay in registers across
iterations; each iteration reads the current window with four gathered
loads straight from the level image, which stays resident in L2. The
11x11 window is padded to 16x16 lanes with masks (Triton blocks are
powers of two).

Scalar set-up that needs `round` (not lowered by Triton) and the origin
clamping of the reference's patch extraction runs in the wrapper, so the
kernel samples exactly the pixels the reference samples; results differ
only in summation order and division rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

# keypoints per program and warps per program (scripts/profile_lk.py
# sweeps both)
GROUP = 1
NUM_WARPS = 1


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _level_kernel(prev_ref, gx_ref, gy_ref, cur_ref,
                  tax_ref, tay_ref, tfx_ref, tfy_ref,
                  ocx_ref, ocy_ref, qx_ref, qy_ref, fz_ref,
                  ox_ref, oy_ref, og_ref, *,
                  h, w, win, wp, pc, iters, eps, min_eig):
    r = win // 2
    g = tax_ref.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (g, wp * wp), 1)
    wy = lane // wp
    wx = lane % wp
    inwin = (wy < win) & (wx < win)
    # lanes outside the window read pixel (0, 0) of the window, masked
    off = jnp.where(inwin, wy * w + wx, 0)

    def sample(ref, ax, ay, fx, fy):
        base = (ay * w + ax)[:, None] + off
        fx = fx[:, None]
        fy = fy[:, None]
        s00 = pltr.load(ref.at[base], mask=inwin, other=0.0)
        s01 = pltr.load(ref.at[base + 1], mask=inwin, other=0.0)
        s10 = pltr.load(ref.at[base + w], mask=inwin, other=0.0)
        s11 = pltr.load(ref.at[base + w + 1], mask=inwin, other=0.0)
        return ((1 - fy) * (1 - fx) * s00 + (1 - fy) * fx * s01
                + fy * (1 - fx) * s10 + fy * fx * s11)

    tax, tay = tax_ref[...], tay_ref[...]
    tfx, tfy = tfx_ref[...], tfy_ref[...]
    T = sample(prev_ref, tax, tay, tfx, tfy)
    Gx = sample(gx_ref, tax, tay, tfx, tfy)
    Gy = sample(gy_ref, tax, tay, tfx, tfy)
    gxx = jnp.sum(Gx * Gx, axis=1)
    gxy = jnp.sum(Gx * Gy, axis=1)
    gyy = jnp.sum(Gy * Gy, axis=1)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    mev = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) * 0.5
    good = (mev / (win * win)) > min_eig
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)

    ocx, ocy = ocx_ref[...], ocy_ref[...]
    ocxf = ocx.astype(jnp.float32)
    ocyf = ocy.astype(jnp.float32)
    hi = float(pc - win - 1)

    def outside(x, y):
        lx = x - r - ocxf
        ly = y - r - ocyf
        b = float(r + 1)
        return ((lx < 0) | (ly < 0) | (lx > hi) | (ly > hi)
                | (x < b) | (x > w - 1 - b) | (y < b) | (y > h - 1 - b))

    x0, y0 = qx_ref[...], qy_ref[...]
    # a point whose G is singular never moves (the reference zeroes its
    # step on every iteration), so it starts frozen
    fz0 = ((fz_ref[...] != 0) | ~good | outside(x0, y0)).astype(jnp.int32)

    def cond(c):
        it, _, _, fz = c
        return (it < iters) & (jnp.min(fz) == 0)

    def body(c):
        it, x, y, fz = c
        lx = x - r - ocxf
        ly = y - r - ocyf
        bx = jnp.clip(jnp.floor(lx), 0.0, hi)
        by = jnp.clip(jnp.floor(ly), 0.0, hi)
        I = sample(cur_ref, ocx + bx.astype(jnp.int32),
                   ocy + by.astype(jnp.int32), lx - bx, ly - by)
        diff = T - I
        bxs = jnp.sum(diff * Gx, axis=1)
        bys = jnp.sum(diff * Gy, axis=1)
        dx = (gyy * bxs - gxy * bys) * inv_det
        dy = (gxx * bys - gxy * bxs) * inv_det
        moving = fz == 0
        nx = x + jnp.where(moving, dx, 0.0)
        ny = y + jnp.where(moving, dy, 0.0)
        conv = dx * dx + dy * dy < eps * eps
        fz = (~moving | conv | outside(nx, ny)).astype(jnp.int32)
        return it + 1, nx, ny, fz

    _, x, y, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), x0, y0, fz0))
    ox_ref[...] = x
    oy_ref[...] = y
    og_ref[...] = good.astype(jnp.int32)


def track_level(img_prev, img_cur, gx, gy, pts_prev, pts_guess, valid, *,
                window: int, margin: int, iters: int, eps: float,
                min_eig: float, interpret: bool = False):
    """Kernel form of `lk._track_level`: returns (pts [N, 2], good [N]),
    where `good` is the reference's G-conditioning test. The caller adds
    the border gates that make it the reference's `ok`."""
    win = window
    r = win // 2
    h, w = img_cur.shape
    pt = win + 2
    pc = min(win + 2 * margin + 2, h, w)
    n = pts_prev.shape[0]
    g = GROUP
    npad = -(-n // g) * g

    # template origin: the reference's clamped patch origin plus the
    # clamped in-patch base, with the in-patch fraction
    tl = jnp.floor(pts_prev).astype(jnp.int32) - r
    org_t = jnp.stack([jnp.clip(tl[:, 0], 0, w - pt),
                       jnp.clip(tl[:, 1], 0, h - pt)], axis=-1)
    local = pts_prev - r - org_t.astype(pts_prev.dtype)
    base = jnp.clip(jnp.floor(local), 0, pt - win - 1)
    frac = local - base
    t_org = org_t + base.astype(jnp.int32)
    # search-patch origin around the rounded seed
    tc = jnp.round(pts_guess).astype(jnp.int32) - (r + margin)
    org_c = jnp.stack([jnp.clip(tc[:, 0], 0, w - pc),
                       jnp.clip(tc[:, 1], 0, h - pc)], axis=-1)
    frozen = (~valid).astype(jnp.int32)

    def pad(a, fill):
        return jnp.pad(a, (0, npad - n), constant_values=fill)

    per_kp = [pad(t_org[:, 0], 0), pad(t_org[:, 1], 0),
              pad(frac[:, 0], 0.0), pad(frac[:, 1], 0.0),
              pad(org_c[:, 0], 0), pad(org_c[:, 1], 0),
              pad(pts_guess[:, 0], 0.0), pad(pts_guess[:, 1], 0.0),
              pad(frozen, 1)]
    images = [img_prev.reshape(-1), gx.reshape(-1), gy.reshape(-1),
              img_cur.reshape(-1)]
    kernel = functools.partial(
        _level_kernel, h=h, w=w, win=win, wp=_next_pow2(win), pc=pc,
        iters=iters, eps=eps, min_eig=min_eig)
    whole = pl.BlockSpec()            # the whole level: gathered from
    kp = pl.BlockSpec((g,), lambda i: (i,))
    ox, oy, og = pl.pallas_call(
        kernel,
        grid=(npad // g,),
        in_specs=[whole] * 4 + [kp] * 9,
        out_specs=[kp, kp, kp],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32),
                   jax.ShapeDtypeStruct((npad,), jnp.float32),
                   jax.ShapeDtypeStruct((npad,), jnp.int32)],
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=interpret,
        name="lk_level",
    )(*images, *per_kp)
    pts = jnp.stack([ox[:n], oy[:n]], axis=-1)
    return pts, og[:n] > 0

"""FAST corner detection — dense, branch-free, whole-image.

Capability parity with the reference's FAST usage (cv::FAST inside grid
cells with a high->low threshold fallback, reference
src/ssvio/orbextractor.cpp:596-647, and the standalone ring test
`isFastCorner`, orbextractor.cpp:194-268).

Instead of the reference's per-cell scalar loops, the ring test is
evaluated for EVERY pixel simultaneously as 16 shifted-image comparisons
(pure elementwise ops that XLA fuses into a handful of
passes). Contiguity of the bright/dark arc is tested with a bitmask trick:
pack the 16 comparisons into a uint32, duplicate it (m | m<<16), and check
whether any 9-long window of ones exists via 8 shift-ANDs. Grid-cell top-K
selection replaces the reference's quad-tree distribution (same goal:
spatial spread; argmax per cell is the array-friendly equivalent).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — the 16-point FAST ring (dy, dx), starting at
# 12 o'clock and going clockwise. (Standard FAST-9/16 definition.)
RING_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9: need >= 9 contiguous ring pixels brighter/darker


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift image so that out[y, x] = img[y + dy, x + dx], edge-padded."""
    h, w = img.shape
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = jnp.pad(img, ((py1, py0), (px1, px0)), mode="edge")
    return jax.lax.dynamic_slice(padded, (py1 + dy, px1 + dx), (h, w))


def _has_contiguous_run(mask_bits: jnp.ndarray, run: int) -> jnp.ndarray:
    """mask_bits: uint32 [H, W] with 16 ring bits set. True if any circular
    window of `run` consecutive bits is all ones."""
    m = mask_bits | (mask_bits << 16)  # unwrap the circle
    acc = m
    for s in range(1, run):
        acc = acc & (m >> s)
    return acc != 0


def fast_score_maps(img: jnp.ndarray, thresholds) -> list:
    """FAST-9 corner response maps for every pixel of [H, W], one per
    threshold, sharing the 16 ring shifts (the bulk of the computation and
    of the emitted HLO — the two-threshold fallback and the 8-octave
    detector would otherwise re-emit them per threshold per octave).

    Score = max over (bright, dark) of sum(|ring - center| - t) over the
    qualifying arc's pixels (OpenCV-compatible flavor of the FAST score —
    here approximated by summing over ALL qualifying ring pixels, which
    preserves ranking for NMS/top-K purposes). Non-corners score 0.
    """
    center = img
    ring = jnp.stack([_shift2d(img, int(dy), int(dx)) for dy, dx in RING_OFFSETS])
    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)

    def arc_mask(cmp: jnp.ndarray) -> jnp.ndarray:
        bits = jnp.zeros(img.shape, dtype=jnp.uint32)
        for i in range(16):
            bits = bits | (cmp[i].astype(jnp.uint32) << i)
        return _has_contiguous_run(bits, ARC_LEN)

    out = []
    for threshold in thresholds:
        t = jnp.float32(threshold)
        brighter = ring > (center + t)[None]          # [16, H, W]
        darker = ring < (center - t)[None]
        is_bright_corner = arc_mask(brighter)
        is_dark_corner = arc_mask(darker)
        diff = jnp.abs(ring - center[None]) - t
        bright_score = jnp.sum(jnp.where(brighter, diff, 0.0), axis=0)
        dark_score = jnp.sum(jnp.where(darker, diff, 0.0), axis=0)
        score = jnp.maximum(jnp.where(is_bright_corner, bright_score, 0.0),
                            jnp.where(is_dark_corner, dark_score, 0.0))
        # kill the 3px border (ring would read padding)
        out.append(jnp.where(border, score, 0.0))
    return out


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Single-threshold FAST-9 response map (see fast_score_maps)."""
    return fast_score_maps(img, [threshold])[0]


def fast_check_sparse(img: jnp.ndarray, xy: jnp.ndarray,
                      threshold: float) -> jnp.ndarray:
    """Per-keypoint FAST-9 ring test at given (sub)pixel positions.

    The sparse analog of the reference's `isFastCorner` re-screen
    (reference src/ssvio/orbextractor.cpp:194-268, applied per octave to
    replicated loop keypoints in ScreenAndComputeKPsParams :844-894):
    rounds xy [N, 2] to pixels, gathers the 16-point Bresenham ring + the
    center (17 gathers per keypoint — cheap next to the 256-tap BRIEF that
    follows), and runs the same bitmask contiguous-arc test the dense
    detector uses. Out-of-border points fail. Returns [N] bool."""
    h, w = img.shape
    ix = jnp.round(xy[..., 0]).astype(jnp.int32)
    iy = jnp.round(xy[..., 1]).astype(jnp.int32)
    inb = (ix >= 3) & (ix < w - 3) & (iy >= 3) & (iy < h - 3)
    ixc = jnp.clip(ix, 3, w - 4)
    iyc = jnp.clip(iy, 3, h - 4)
    center = img[iyc, ixc]                                   # [N]
    ring = jnp.stack([img[iyc + int(dy), ixc + int(dx)]
                      for dy, dx in RING_OFFSETS])           # [16, N]
    t = jnp.float32(threshold)
    brighter = ring > (center + t)[None]
    darker = ring < (center - t)[None]

    def arc(cmp):
        bits = jnp.zeros(center.shape, jnp.uint32)
        for i in range(16):
            bits = bits | (cmp[i].astype(jnp.uint32) << i)
        return _has_contiguous_run(bits, ARC_LEN)

    return inb & (arc(brighter) | arc(darker))


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep scores that are the strict max of their 3x3 neighborhood."""
    neigh = jnp.stack([_shift2d(score, dy, dx)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if not (dy == 0 and dx == 0)])
    is_max = score >= jnp.max(neigh, axis=0)
    return jnp.where(is_max, score, 0.0)


def detect_grid(img: jnp.ndarray, max_kps: int, cell: int = 32,
                ini_threshold: float = 20.0, min_threshold: float = 7.0,
                occupancy: jnp.ndarray | None = None,
                kps_per_cell: int = 4,
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Grid-distributed FAST detection over a full image.

    Mirrors the reference's two-threshold scheme (orbextractor.cpp:616-627):
    the response map is computed at BOTH thresholds; cells that found nothing
    at `ini_threshold` fall back to `min_threshold` responses. Per cell the
    top `kps_per_cell` NMS survivors are kept (array analog of the quad-tree
    spread, orbextractor.cpp:340-568), then the global top `max_kps` by
    response are selected.

    Args:
      occupancy: optional [H, W] bool — True pixels are BLOCKED (e.g. near
        existing features, the reference's +-10px mask, frontend.cpp:304-312).

    Returns (xy [max_kps, 2] float32, response [max_kps], valid [max_kps]).
    """
    h, w = img.shape
    raw_hi, raw_lo = fast_score_maps(img, [ini_threshold, min_threshold])
    score_hi = nms3x3(raw_hi)
    score_lo = nms3x3(raw_lo)
    if occupancy is not None:
        score_hi = jnp.where(occupancy, 0.0, score_hi)
        score_lo = jnp.where(occupancy, 0.0, score_lo)

    # pad to multiples of cell
    H = -(-h // cell) * cell
    W = -(-w // cell) * cell
    pad = ((0, H - h), (0, W - w))
    score_hi = jnp.pad(score_hi, pad)
    score_lo = jnp.pad(score_lo, pad)
    ny, nx = H // cell, W // cell

    def cells(s):
        return s.reshape(ny, cell, nx, cell).transpose(0, 2, 1, 3).reshape(ny * nx, cell * cell)

    c_hi = cells(score_hi)
    c_lo = cells(score_lo)
    # fallback: cell uses low-threshold map only if high found nothing there
    use_lo = (jnp.max(c_hi, axis=1, keepdims=True) <= 0.0)
    c = jnp.where(use_lo, c_lo, c_hi)

    # top-k per cell
    vals, idx = jax.lax.top_k(c, kps_per_cell)            # [C, k]
    cy = jnp.arange(ny * nx, dtype=jnp.int32) // nx * 0   # placeholder
    cell_ids = jnp.arange(ny * nx, dtype=jnp.int32)
    cell_y = (cell_ids // nx) * cell
    cell_x = (cell_ids % nx) * cell
    py = cell_y[:, None] + idx // cell
    px = cell_x[:, None] + idx % cell
    flat_vals = vals.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)

    # global top max_kps
    k = min(max_kps, flat_vals.shape[0])
    top_vals, top_idx = jax.lax.top_k(flat_vals, k)
    sel_y = flat_y[top_idx]
    sel_x = flat_x[top_idx]
    valid = top_vals > 0.0
    xy = jnp.stack([sel_x.astype(jnp.float32), sel_y.astype(jnp.float32)], axis=-1)
    if k < max_kps:
        xy = jnp.pad(xy, ((0, max_kps - k), (0, 0)))
        top_vals = jnp.pad(top_vals, (0, max_kps - k))
        valid = jnp.pad(valid, (0, max_kps - k))
    return xy, top_vals, valid


def detect_multiscale(pyr, scale_factor: float, max_kps: int,
                      cell: int = 32, ini_threshold: float = 20.0,
                      min_threshold: float = 7.0,
                      occupancy: jnp.ndarray | None = None,
                      kps_per_cell: int = 4, dedupe_cell: int = 4,
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                 jnp.ndarray]:
    """Scale-covariant grid FAST over a geometric pyramid.

    Mirrors the reference's per-octave detection (ComputeKeyPointsOctTree,
    reference orbextractor.cpp:572-676: FAST with the two-threshold
    fallback inside fixed-size cells AT EVERY OCTAVE, keypoints mapped back
    to level-0 coordinates with their octave recorded) with the same
    per-level keypoint budget split (proportional to 1/scale^l, the
    reference's mnFeaturesPerLevel geometric series, orbextractor.cpp's
    constructor).

    Deviations: grid top-K per octave instead of the quad-tree
    (same goal — spatial spread), and cross-octave duplicates (one physical
    corner firing at several scales) resolved by a scatter-max over a
    `dedupe_cell`-px level-0 grid — the winning octave's response survives,
    a tracked feature set wants one point per corner (the reference keeps
    multi-octave duplicates because its descriptors are per-octave; our
    loop descriptors are computed over the full ladder per feature).

    pyr: list of [Hl, Wl] images (pyramid.build_orb_pyramid order).
    occupancy: optional [H0, W0] bool, blocked at level-0 (downsampled to
      each octave).
    Returns (xy0 [max_kps, 2] level-0 coords, response [max_kps],
             octave [max_kps] int32, valid [max_kps]).
    """
    from ssvio_tpu.ops import pyramid as pyrmod
    L = len(pyr)
    h0, w0 = pyr[0].shape
    inv = np.array([scale_factor ** -l for l in range(L)])
    budgets = [max(8, int(round(max_kps * wl))) for wl in inv / inv.sum()]

    xs, rs, os_, vs = [], [], [], []
    for l in range(L):
        img = pyr[l]
        s = float(scale_factor ** l)
        occ_l = None
        if occupancy is not None:
            if l == 0:
                occ_l = occupancy
            else:
                hl, wl = img.shape
                occ_l = pyrmod.resize_bilinear(
                    occupancy.astype(jnp.float32), hl, wl) > 0.25
        xy_l, resp_l, val_l = detect_grid(
            img, max_kps=budgets[l], cell=cell,
            ini_threshold=ini_threshold, min_threshold=min_threshold,
            occupancy=occ_l, kps_per_cell=kps_per_cell)
        xs.append(xy_l * s)
        rs.append(resp_l)
        os_.append(jnp.full((budgets[l],), l, jnp.int32))
        vs.append(val_l)
    xy0 = jnp.concatenate(xs)
    resp = jnp.where(jnp.concatenate(vs), jnp.concatenate(rs), 0.0)
    octv = jnp.concatenate(os_)

    # cross-octave dedupe: best response per dedupe_cell wins
    gx = jnp.clip(xy0[:, 0].astype(jnp.int32) // dedupe_cell, 0,
                  w0 // dedupe_cell)
    gy = jnp.clip(xy0[:, 1].astype(jnp.int32) // dedupe_cell, 0,
                  h0 // dedupe_cell)
    nx = w0 // dedupe_cell + 1
    gi = gy * nx + gx
    gmax = jnp.zeros(((h0 // dedupe_cell + 1) * nx,), resp.dtype)
    gmax = gmax.at[gi].max(resp)
    # strict winner per cell; exact-tie duplicates resolved by keeping the
    # first (cheapest arg-tiebreak: penalize later candidates by index eps)
    order_eps = jnp.arange(resp.shape[0], dtype=resp.dtype) * 1e-6
    keyed = jnp.where(resp > 0, resp - order_eps, 0.0)
    gbest = jnp.zeros_like(gmax).at[gi].max(keyed)
    win = (keyed >= gbest[gi]) & (resp > 0)
    resp_d = jnp.where(win, resp, 0.0)

    k = min(max_kps, resp_d.shape[0])
    top_vals, top_idx = jax.lax.top_k(resp_d, k)
    out_xy = xy0[top_idx]
    out_oct = octv[top_idx]
    valid = top_vals > 0.0
    if k < max_kps:
        out_xy = jnp.pad(out_xy, ((0, max_kps - k), (0, 0)))
        top_vals = jnp.pad(top_vals, (0, max_kps - k))
        out_oct = jnp.pad(out_oct, (0, max_kps - k))
        valid = jnp.pad(valid, (0, max_kps - k))
    return out_xy, top_vals, out_oct, valid


def build_occupancy(h: int, w: int, xy: jnp.ndarray, valid: jnp.ndarray,
                    radius: int = 10) -> jnp.ndarray:
    """Rasterize existing feature positions into a blocked mask, dilated to
    +-radius (the reference masks a 20x20 rect around each feature,
    frontend.cpp:304-312). Scatter + separable box dilation.
    """
    ix = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    base = jnp.zeros((h, w), dtype=jnp.float32)
    base = base.at[iy, ix].add(valid.astype(jnp.float32))
    # separable box dilation via two 1-D max filters
    occ = base
    p = jnp.pad(occ, ((radius, radius), (0, 0)))
    occ = jnp.max(jnp.stack([p[i:i + h] for i in range(2 * radius + 1)]), axis=0)
    p = jnp.pad(occ, ((0, 0), (radius, radius)))
    occ = jnp.max(jnp.stack([p[:, i:i + w] for i in range(2 * radius + 1)]), axis=0)
    return occ > 0.0

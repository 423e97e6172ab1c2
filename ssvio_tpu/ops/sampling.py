"""Batched image sampling primitives (the gather core of the front end).

Every front-end kernel (LK windows, BRIEF pattern taps, IC-angle patches)
reduces to "sample the image at N floating-point positions": one flat
gather over precomputed flattened indices, which XLA vectorizes.
Out-of-bounds positions clamp to the border (callers gate validity
separately so clamped taps never influence accepted results).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def gather_nn(img: jnp.ndarray, pts_xy: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor sample. img [H, W]; pts_xy [..., 2] (x, y) -> [...]."""
    h, w = img.shape
    x = jnp.clip(jnp.round(pts_xy[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(pts_xy[..., 1]).astype(jnp.int32), 0, h - 1)
    flat = img.reshape(-1)
    return flat[y * w + x]


def gather_bilinear(img: jnp.ndarray, pts_xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample. img [H, W]; pts_xy [..., 2] (x, y) -> [...] float32."""
    h, w = img.shape
    x = pts_xy[..., 0]
    y = pts_xy[..., 1]
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.clip(x0f.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    flat = img.reshape(-1)
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def in_bounds(pts_xy: jnp.ndarray, h: int, w: int, border: float = 0.0) -> jnp.ndarray:
    """[..., 2] -> [...] bool, True if inside [border, dim-1-border]."""
    x, y = pts_xy[..., 0], pts_xy[..., 1]
    return ((x >= border) & (x <= w - 1 - border) &
            (y >= border) & (y <= h - 1 - border))

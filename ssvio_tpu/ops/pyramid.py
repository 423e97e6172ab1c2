"""Image pyramids: Gaussian blur + downsampling, all static shapes.

Two pyramids serve different consumers (mirroring the reference):
- LK pyramid: power-of-two downsampling, `lk_levels` deep (reference uses
  OpenCV's 3-level LK pyramid, src/ssvio/frontend.cpp:156-166).
- ORB detection pyramid: geometric `scale_factor` (1.2) over `n_levels` (8)
  octaves (reference src/ssvio/orbextractor.cpp:993-1027) for scale-covariant
  FAST + descriptors.

Blur is separable and written as statically shifted weighted adds that XLA
fuses into one elementwise pass; decimation is a reshape plus static slice. All shapes derive from the
config at trace time, so each level is a fixed-shape array and the whole
pyramid jits once.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur of [H, W] (matches the reference's 7x7 sigma=2
    pre-descriptor blur, reference src/ssvio/orbextractor.cpp:732,962).

    Implemented as 2r+1 statically-shifted weighted adds per direction
    rather than a 1-channel lax.conv: the shift-add form fuses into one
    elementwise pass."""
    k = gaussian_kernel1d(sigma, radius)
    h, w = img.shape
    p = jnp.pad(img, ((0, 0), (radius, radius)), mode="edge")
    x = sum(float(k[i]) * lax.slice(p, (0, i), (h, i + w))
            for i in range(2 * radius + 1))
    p = jnp.pad(x, ((radius, radius), (0, 0)), mode="edge")
    return sum(float(k[i]) * lax.slice(p, (i, 0), (i + h, w))
               for i in range(2 * radius + 1))


def _bilinear_resize_weights(src: int, dst: int, scale: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precomputed (i0, i1, frac) for 1-D bilinear resampling at fixed scale."""
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, src - 1.0)
    i0 = np.floor(coords).astype(np.int32)
    i1 = np.minimum(i0 + 1, src - 1).astype(np.int32)
    frac = (coords - i0).astype(np.float32)
    return i0, i1, frac


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Static-shape bilinear resize of [H, W] -> [out_h, out_w]."""
    h, w = img.shape
    yi0, yi1, yf = _bilinear_resize_weights(h, out_h, h / out_h)
    xi0, xi1, xf = _bilinear_resize_weights(w, out_w, w / out_w)
    yi0, yi1 = jnp.asarray(yi0), jnp.asarray(yi1)
    xi0, xi1 = jnp.asarray(xi0), jnp.asarray(xi1)
    yf = jnp.asarray(yf)[:, None]
    xf = jnp.asarray(xf)[None, :]
    top = img[yi0][:, xi0] * (1 - xf) + img[yi0][:, xi1] * xf
    bot = img[yi1][:, xi0] * (1 - xf) + img[yi1][:, xi1] * xf
    return top * (1 - yf) + bot * yf


def lk_pyramid_shapes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    return [(h >> l, w >> l) for l in range(levels)]


def build_lk_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """Power-of-two pyramid with light anti-alias blur per level."""
    pyr = [img]
    cur = img
    for _ in range(1, levels):
        smoothed = blur(cur, sigma=1.0, radius=2)
        # 2x decimation (even rows/cols of the smoothed image) via
        # reshape+static-slice, which needs no gather
        h, w = smoothed.shape
        cur = smoothed.reshape(h // 2, 2, w // 2, 2)[:, 0, :, 0]
        pyr.append(cur)
    return pyr


def orb_pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float
                       ) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((max(16, int(round(h / s))), max(16, int(round(w / s)))))
    return shapes


def build_orb_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float
                      ) -> List[jnp.ndarray]:
    """Geometric-scale pyramid for multi-octave detection (reference
    ComputePyramid, orbextractor.cpp:993-1027). Shapes are static per config."""
    h, w = img.shape
    shapes = orb_pyramid_shapes(h, w, n_levels, scale_factor)
    pyr = [img]
    for l in range(1, n_levels):
        # resize from previous level (cascaded, like the reference) after a
        # light blur to avoid aliasing
        prev = blur(pyr[-1], sigma=0.8, radius=2)
        oh, ow = shapes[l]
        pyr.append(resize_bilinear(prev, oh, ow))
    return pyr


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.array([scale_factor ** l for l in range(n_levels)], dtype=np.float32)


def sobel_gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scharr-like 3x3 gradients (used by LK). Returns (gx, gy), same shape."""
    p = jnp.pad(img, 1, mode="edge")
    # central differences with [1 2 1]/4 cross smoothing (Sobel/8 normalization
    # -> intensity units per pixel)
    gx = ((p[1:-1, 2:] - p[1:-1, :-2]) * 2 +
          (p[:-2, 2:] - p[:-2, :-2]) +
          (p[2:, 2:] - p[2:, :-2])) * 0.125
    gy = ((p[2:, 1:-1] - p[:-2, 1:-1]) * 2 +
          (p[2:, :-2] - p[:-2, :-2]) +
          (p[2:, 2:] - p[:-2, 2:])) * 0.125
    return gx, gy

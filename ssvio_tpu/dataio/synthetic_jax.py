"""Device-side synthetic stereo renderer (JAX port of dataio.synthetic).

The numpy raycaster in `dataio.synthetic` costs seconds per
KITTI-resolution stereo pair on a host CPU. This module renders the SAME
world (same texture tables, same plane geometry, same supersampling) as a
jitted JAX program, so benchmark/test sequences are produced directly in
device memory.

Parity: `tests/test_synthetic_jax.py` checks the output against the numpy
renderer pixel-for-pixel (small float tolerance; the numpy path raycasts in
f64, this one in f32 — block-texture boundaries may land one texel off for
a handful of pixels).

Reference analog: the reference's synthetic source is the UI demo's
constant-velocity pose generator (reference test/test_ui.cpp:27-70); real
imagery comes from disk. This renderer is our hermetic stand-in for that
disk (see dataio/synthetic.py docstring).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ssvio_tpu.dataio import synthetic as syn


class WorldArrays(NamedTuple):
    """SyntheticWorld's texture tables + plane geometry as arrays."""
    blocks: jnp.ndarray     # [4, T, T] f32 — ground, wall_l, wall_r, ceiling
    smooth: jnp.ndarray     # [4, T, T] f32
    ground_y: float
    wall_x: float
    ceiling_y: float


def world_arrays(world: syn.SyntheticWorld) -> WorldArrays:
    texs = [world.tex_ground, world.tex_wall_l, world.tex_wall_r,
            world.tex_ceil]
    return WorldArrays(
        blocks=jnp.asarray(np.stack([t.blocks for t in texs])),
        smooth=jnp.asarray(np.stack([t.smooth for t in texs])),
        ground_y=float(world.ground_y), wall_x=float(world.wall_x),
        ceiling_y=float(world.ceiling_y))


def _sample_texture(blocks_flat, smooth_flat, base, u, v, t):
    """JAX port of BlockNoiseTexture.sample (dataio/synthetic.py:32-66).

    `blocks_flat`/`smooth_flat` are the [4, T, T] tables flattened to
    [4*T*T]; `base` is the per-pixel plane id * T*T, so each pixel samples
    ONLY its winning plane's texture (4x fewer gathers than shading all
    four planes everywhere; gathers dominate the render cost)."""
    def tap(tab, iu, iv):
        return tab[base + iu * t + iv]

    iu = jnp.floor(u).astype(jnp.int32) % t
    iv = jnp.floor(v).astype(jnp.int32) % t
    val = tap(blocks_flat, iu, iv)
    iu2 = jnp.floor(u * 4.0 + 131).astype(jnp.int32) % t
    iv2 = jnp.floor(v * 4.0 + 57).astype(jnp.int32) % t
    val = 0.65 * val + 0.35 * tap(blocks_flat, iu2, iv2)
    iu3 = (jnp.floor(u / 8.0) + 811).astype(jnp.int32) % t
    iv3 = (jnp.floor(v / 8.0) + 409).astype(jnp.int32) % t
    val = 0.6 * val + 0.4 * tap(blocks_flat, iu3, iv3)
    us, vs = u / 3.0, v / 3.0
    i0f = jnp.floor(us)
    j0f = jnp.floor(vs)
    fu = (us - i0f).astype(jnp.float32)
    fv = (vs - j0f).astype(jnp.float32)
    i0 = i0f.astype(jnp.int32) % t
    j0 = j0f.astype(jnp.int32) % t
    i1 = (i0 + 1) % t
    j1 = (j0 + 1) % t
    s = (tap(smooth_flat, i0, j0) * (1 - fu) * (1 - fv)
         + tap(smooth_flat, i1, j0) * fu * (1 - fv)
         + tap(smooth_flat, i0, j1) * (1 - fu) * fv
         + tap(smooth_flat, i1, j1) * fu * fv)
    return jnp.clip(val + s, 0.0, 255.0)


def _render_one(w: WorldArrays, T_wc, fx, fy, cx, cy, width: int,
                height: int, supersample: int = 2):
    """One grayscale frame [H, W] f32 (synthetic.SyntheticWorld.render)."""
    s = supersample
    fx, fy = fx * s, fy * s
    cx, cy = cx * s + (s - 1) / 2.0, cy * s + (s - 1) / 2.0
    W, H = width * s, height * s
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    d_c = jnp.stack([(u - cx) / fx, (v - cy) / fy, jnp.ones_like(u)], -1)
    d_w = d_c @ R.T                                     # [H, W, 3]
    dx, dy = d_w[..., 0], d_w[..., 1]
    inf = jnp.float32(np.inf)

    def plane_t(num, den, sign):
        # hit distance along the ray; inf where the ray can't hit the plane
        ok = (den * sign) > 1e-9
        t = num / jnp.where(ok, den, 1.0)
        return jnp.where(ok & (t > 0.05), t, inf)

    ts = jnp.stack([
        plane_t(w.ground_y - o[1], dy, 1.0),            # ground  (tex 0)
        plane_t(-w.wall_x - o[0], dx, -1.0),            # wall_l  (tex 1)
        plane_t(w.wall_x - o[0], dx, 1.0),              # wall_r  (tex 2)
        plane_t(w.ceiling_y - o[1], dy, -1.0),          # ceiling (tex 3)
    ])                                                  # [4, H, W]
    best = jnp.argmin(ts, axis=0).astype(jnp.int32)     # winning plane/pixel
    tbest = jnp.min(ts, axis=0)
    hit = jnp.isfinite(tbest)
    p = o[None, None, :] + jnp.where(hit, tbest, 0.0)[..., None] * d_w
    # texture-plane (u, v) axes: ground/ceiling -> (x, z), walls -> (z, y)
    wall = (best == 1) | (best == 2)
    pu = jnp.where(wall, p[..., 2], p[..., 0])
    pv = jnp.where(wall, p[..., 1], p[..., 2])
    t = w.blocks.shape[-1]
    shade = _sample_texture(w.blocks.reshape(-1), w.smooth.reshape(-1),
                            best * (t * t), pu, pv, t)
    img = jnp.where(hit, shade, 128.0)
    if s > 1:
        img = img.reshape(height, s, width, s).mean(axis=(1, 3))
    return img.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("width", "height", "pad_w",
                                             "pad_h", "supersample", "u8",
                                             "noise_std"))
def render_stereo_chunk(w: WorldArrays, poses_wc, fx, fy, cx, cy, baseline,
                        width: int, height: int, pad_w: int = 0,
                        pad_h: int = 0, supersample: int = 2,
                        u8: bool = True, noise_std: float = 0.0,
                        key=None, frame0=0):
    """Render a [K,3,4] T_wc pose chunk -> (left [K,h,w], right [K,h,w]).

    `pad_w`/`pad_h` edge-pad to the engine's device dims (System._pad
    semantics) so the output feeds dispatch_chunk directly with no host
    round-trip. u8=True returns camera-native uint8 (what KITTI provides).

    `noise_std` > 0 adds per-pixel Gaussian sensor noise (gray levels) at
    native resolution, deterministic per global frame index (`frame0` +
    chunk offset, independent per eye) — the clean raycast renders LK
    tracks to sub-0.05 px accuracy and the resulting trajectories barely
    drift, which makes loop-closing benchmarks vacuous; real sensors
    don't behave that way.
    """
    pw = pad_w or width
    ph = pad_h or height
    if noise_std > 0.0 and key is None:
        raise ValueError("noise_std > 0 needs a PRNG `key`")
    K = poses_wc.shape[0]
    idx = frame0 + jnp.arange(K, dtype=jnp.int32)
    keys = (jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
            if noise_std > 0.0 else jnp.zeros((K, 2), jnp.uint32))

    def one(args):
        T, k = args
        L = _render_one(w, T, fx, fy, cx, cy, width, height, supersample)
        T_r_t = T[:, 3] + T[:, :3] @ jnp.array([1.0, 0.0, 0.0]) * baseline
        T_r = jnp.concatenate([T[:, :3], T_r_t[:, None]], axis=1)
        R = _render_one(w, T_r, fx, fy, cx, cy, width, height, supersample)
        if noise_std > 0.0:
            kl, kr = jax.random.split(k)
            L = L + noise_std * jax.random.normal(kl, L.shape, L.dtype)
            R = R + noise_std * jax.random.normal(kr, R.shape, R.dtype)

        def pad(img):
            img = jnp.pad(img, ((0, ph - height), (0, pw - width)),
                          mode="edge")
            return jnp.clip(img, 0, 255).astype(jnp.uint8) if u8 else img
        return pad(L), pad(R)

    return jax.lax.map(one, (poses_wc, keys))


def render_stereo_sequence_device(world: syn.SyntheticWorld, poses_wc,
                                  fx, fy, cx, cy, baseline, width, height,
                                  pad_w: int = 0, pad_h: int = 0,
                                  chunk: int = 32, u8: bool = True,
                                  noise_std: float = 0.0,
                                  noise_seed: int = 0):
    """Render a whole trajectory into device memory, `chunk` frames per
    dispatch (bounds the supersampled intermediate footprint).
    Returns (left [N,h,w], right [N,h,w]) device arrays."""
    w = world_arrays(world)
    poses_wc = jnp.asarray(np.asarray(poses_wc, np.float32))
    n = poses_wc.shape[0]
    key = jax.random.PRNGKey(noise_seed) if noise_std > 0.0 else None
    outs_l, outs_r = [], []
    for c in range(0, n, chunk):
        L, R = render_stereo_chunk(
            w, poses_wc[c:c + chunk], fx, fy, cx, cy, baseline,
            width, height, pad_w, pad_h, u8=u8, noise_std=noise_std,
            key=key, frame0=c)
        outs_l.append(L)
        outs_r.append(R)
    return jnp.concatenate(outs_l), jnp.concatenate(outs_r)

"""Oriented BRIEF (ORB-style) descriptors, batched over keypoints.

Capability parity with the reference ORBextractor's orientation + descriptor
stages (reference src/ssvio/orbextractor.cpp: IC_Angle :15-43,
computeOrbDescriptor :46-91, CalcDescriptors :943-991): intensity-centroid
orientation over a radius-15 circular patch, then a 256-pair steered binary
test packed into 32 bytes.

Design notes (not a port):
- The reference uses ORB-SLAM's learned `bit_pattern_31_` table
  (reference src/ssvio/orbpattern.cpp). We deliberately do NOT copy that
  table: descriptors here are self-consistent within the engine (matching,
  vocabulary, loop closing are all trained/performed on OUR descriptors), so
  we generate the classic BRIEF sampling pattern procedurally — Gaussian
  (0, patch/5) pairs, seeded and deterministic (Calonder et al., BRIEF,
  ECCV 2010) — with a greedy decorrelation pass in the spirit of ORB's
  offline learning (Rublee et al., ICCV 2011).
- All keypoints are processed as one batch of flat gathers; bit packing is
  a [N, 256] bool -> [N, 8] uint32 dot with power-of-two weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np  # noqa: F401

from ssvio_tpu.ops import sampling

PATCH_RADIUS = 15          # IC-angle circular patch radius (reference HALF_PATCH_SIZE)
DESC_BITS = 256
DESC_WORDS = 8             # uint32 words per descriptor


@functools.lru_cache()
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 4] int8 sampling pairs (x1, y1, x2, y2) in a 31x31 patch.

    Gaussian-sampled i.i.d. pairs (BRIEF GI sampling: sigma = patch/5 = 6.2),
    clipped to +-13 so rotated taps stay inside the 31x31 window for any
    angle (13 * sqrt(2) < 15 within rounding slack).
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 6.2, size=(DESC_BITS * 4, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.int8)
    pairs = pts.reshape(DESC_BITS * 2, 4)
    # drop degenerate pairs (identical endpoints), keep first 256
    good = pairs[(pairs[:, 0] != pairs[:, 2]) | (pairs[:, 1] != pairs[:, 3])]
    assert len(good) >= DESC_BITS
    return good[:DESC_BITS]


@functools.lru_cache()
def _ic_angle_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """Circular-patch tap offsets [(K, 2) int32 (dx, dy)] and mask weights."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs ** 2 + ys ** 2) <= r ** 2
    offs = np.stack([xs[mask], ys[mask]], axis=-1).astype(np.int32)
    return offs, offs.astype(np.float32)


def ic_angle(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint.

    img [H, W] float32; xy [N, 2]. Returns angle [N] radians.
    Matches reference IC_Angle semantics (orbextractor.cpp:15-43):
    theta = atan2(m01, m10) over the circular radius-15 patch.
    """
    offs, offs_f = _ic_angle_offsets()
    taps = xy[:, None, :] + jnp.asarray(offs_f)           # [N, K, 2]
    vals = sampling.gather_nn(img, taps)                  # [N, K]
    m10 = jnp.sum(vals * jnp.asarray(offs_f[:, 0])[None], axis=1)
    m01 = jnp.sum(vals * jnp.asarray(offs_f[:, 1])[None], axis=1)
    return jnp.arctan2(m01, m10)


@functools.lru_cache()
def _moment_kernel() -> np.ndarray:
    """[2, 1, 31, 31] conv kernel computing (m10, m01) patch moments."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs ** 2 + ys ** 2) <= r ** 2
    # XLA's conv is cross-correlation (no kernel flip): moment(x) =
    # sum_o img(x+o)*k(o) with k(o) = o
    kx = np.where(mask, xs, 0).astype(np.float32)
    ky = np.where(mask, ys, 0).astype(np.float32)
    return np.stack([kx, ky])[:, None]


def ic_angle_conv(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """ic_angle via two whole-image moment convolutions + ONE gather per
    keypoint per moment: the per-tap gather version issues ~709 random
    gathers per keypoint, where a 31x31 conv is one dense pass. Numerically IDENTICAL to ic_angle for
    keypoints whose full patch is in bounds (all integer taps:
    round(xy)+o == round(xy+o)); border keypoints differ (zero-pad vs
    clamp) but descriptor validity already excludes them (border 22 >
    PATCH_RADIUS)."""
    k = jnp.asarray(_moment_kernel())
    m = jax.lax.conv_general_dilated(
        img[None, None], k, window_strides=(1, 1), padding="SAME")
    c = jnp.round(xy)
    m10 = sampling.gather_nn(m[0, 0], c)
    m01 = sampling.gather_nn(m[0, 1], c)
    return jnp.arctan2(m01, m10)


@functools.lru_cache()
def _circle_rows() -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (dy, halfwidth) of the radius-15 circular patch — the same
    tap set as _ic_angle_offsets, expressed row-wise."""
    r = PATCH_RADIUS
    dys = np.arange(-r, r + 1, dtype=np.int32)
    ws = np.floor(np.sqrt(float(r * r) - dys.astype(np.float64) ** 2) + 1e-9
                  ).astype(np.int32)
    return dys, ws


def ic_angle_integral(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """ic_angle via row-wise integral images: 4 gathers per patch ROW
    instead of one per TAP (124 vs ~709 gathers per keypoint).

    Exactly the same tap set as ic_angle:
      S(dy)  = sum_{|dx|<=w(dy)} img[cy+dy, cx+dx]   (prefix-sum diff)
      Sx(dy) = sum (cx+dx)*img[...]                  (first-moment prefix)
      m01 = sum dy*S(dy),  m10 = sum (Sx(dy) - cx*S(dy))
    Identical for interior keypoints (integer taps); border keypoints
    (clamped differently) are excluded by descriptor validity anyway."""
    H, W = img.shape
    z = jnp.zeros((H, 1), img.dtype)
    II = jnp.concatenate([z, jnp.cumsum(img, axis=1)], axis=1)   # [H, W+1]
    xs = jnp.arange(W, dtype=img.dtype)
    Ix = jnp.concatenate([z, jnp.cumsum(img * xs[None, :], axis=1)], axis=1)
    dys, ws = _circle_rows()
    dys_d = jnp.asarray(dys)
    ws_d = jnp.asarray(ws)
    c = jnp.round(xy).astype(jnp.int32)
    cy = jnp.clip(c[:, 1:2] + dys_d[None, :], 0, H - 1)          # [N, 31]
    lo = jnp.clip(c[:, 0:1] - ws_d[None, :], 0, W)               # [N, 31]
    hi = jnp.clip(c[:, 0:1] + ws_d[None, :] + 1, 0, W)
    base = cy * (W + 1)
    fII = II.reshape(-1)
    fIx = Ix.reshape(-1)
    S = fII[base + hi] - fII[base + lo]
    Sx = fIx[base + hi] - fIx[base + lo]
    f = img.dtype
    m01 = jnp.sum(S * dys_d.astype(f)[None, :], axis=1)
    m10 = jnp.sum(Sx - c[:, 0:1].astype(f) * S, axis=1)
    return jnp.arctan2(m01, m10)


def load_pattern_file(path: str) -> np.ndarray:
    """Load an external 256-pair BRIEF sampling pattern.

    Format: 1024 whitespace-separated integers (x1 y1 x2 y2 per pair, any
    line structure; '#'/'//' comments and separators like ',' tolerated) —
    exactly how ORB-SLAM's learned `bit_pattern_31_` initializer prints
    (reference src/ssvio/orbpattern.cpp:9; also OpenCV's
    modules/features2d/src/orb.cpp). We deliberately do not ship that
    table; pointing Settings.brief_pattern_path at a dump of it makes the
    engine's descriptors (and therefore a loaded ORBvoc tree,
    Settings.vocab_path) semantically compatible with ORB-SLAM/reference
    descriptors. Returns [256, 4] int8.
    """
    nums = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].split("//")[0]
            for tok in line.replace(",", " ").replace(";", " ").split():
                nums.append(int(tok))
    arr = np.asarray(nums, np.int32)
    if arr.size != DESC_BITS * 4:
        raise ValueError(
            f"BRIEF pattern file {path!r} holds {arr.size} ints; need "
            f"{DESC_BITS * 4} (256 pairs x 4 coords)")
    if np.abs(arr).max() > 15:
        raise ValueError(
            "pattern coordinates must lie in [-15, 15] (a 31x31 patch)")
    return arr.reshape(DESC_BITS, 4).astype(np.int8)


def compute_descriptors(img_blurred: jnp.ndarray, xy: jnp.ndarray,
                        angle: jnp.ndarray, seed: int = 1234,
                        pattern: np.ndarray | None = None) -> jnp.ndarray:
    """Steered-BRIEF descriptors.

    img_blurred: [H, W] float32, pre-blurred (reference applies GaussianBlur
      7x7 sigma=2 before descriptors, orbextractor.cpp:962).
    xy: [N, 2] keypoint positions (in this image's scale).
    angle: [N] orientation radians.
    pattern: optional [256, 4] explicit sampling pairs (load_pattern_file);
      defaults to the procedural seeded pattern.

    Returns [N, 8] uint32 (256 bits packed little-endian within words).
    """
    pat_np = brief_pattern(seed) if pattern is None else np.asarray(pattern)
    pat = jnp.asarray(pat_np.astype(np.float32))               # [256, 4]
    ca = jnp.cos(angle)[:, None]                                # [N, 1]
    sa = jnp.sin(angle)[:, None]
    # rotate both endpoints of each pair by the keypoint angle
    def rot(px, py):
        return px * ca - py * sa, px * sa + py * ca
    x1, y1 = rot(pat[None, :, 0], pat[None, :, 1])              # [N, 256]
    x2, y2 = rot(pat[None, :, 2], pat[None, :, 3])
    p1 = jnp.stack([xy[:, None, 0] + x1, xy[:, None, 1] + y1], axis=-1)
    p2 = jnp.stack([xy[:, None, 0] + x2, xy[:, None, 1] + y2], axis=-1)
    v1 = sampling.gather_nn(img_blurred, p1)                    # [N, 256]
    v2 = sampling.gather_nn(img_blurred, p2)
    bits = (v1 < v2).astype(jnp.uint32)                         # [N, 256]
    bits = bits.reshape(-1, DESC_WORDS, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)   # [N, 8]


@functools.lru_cache()
def brief_pool_pattern(seed: int = 4321) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-style BRIEF pattern: 256 sample POINTS + 256 index PAIRS.

    The classic pattern samples 512 independent endpoints (2 gathers per
    bit); drawing both endpoints of every pair from a shared 256-point
    pool halves the image gathers — the bit comparisons become STATIC
    shuffles of the pooled values. Point reuse does not hurt
    distinctiveness (ORB's learned bit_pattern_31_ itself reuses
    coordinates heavily); the pairing is seeded to avoid duplicate and
    self pairs. Returns (points [256, 2] int8, pairs [256, 2] int32)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(0.0, 6.2, size=(DESC_BITS, 2))),
                  -13, 13).astype(np.int8)
    pairs = np.zeros((DESC_BITS, 2), np.int32)
    seen = set()
    k = 0
    while k < DESC_BITS:
        a, b = rng.integers(0, DESC_BITS, 2)
        if a == b or (pts[a] == pts[b]).all():
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        pairs[k] = (a, b)
        k += 1
    return pts, pairs


def compute_descriptors_pool(img_blurred: jnp.ndarray, xy: jnp.ndarray,
                             angle: jnp.ndarray, seed: int = 4321
                             ) -> jnp.ndarray:
    """Steered BRIEF with the pooled pattern: ONE 256-tap gather per
    keypoint (vs 512 for compute_descriptors); pair comparisons are
    static-index shuffles. Same contract/packing as compute_descriptors
    (descriptors are self-consistent within the engine either way — the
    vocabulary is trained on whichever pattern produced them)."""
    pts, pairs = brief_pool_pattern(seed)
    pat = jnp.asarray(pts.astype(np.float32))                   # [256, 2]
    ca = jnp.cos(angle)[:, None]
    sa = jnp.sin(angle)[:, None]
    px = pat[None, :, 0] * ca - pat[None, :, 1] * sa            # [N, 256]
    py = pat[None, :, 0] * sa + pat[None, :, 1] * ca
    p = jnp.stack([xy[:, None, 0] + px, xy[:, None, 1] + py], axis=-1)
    v = sampling.gather_nn(img_blurred, p)                      # [N, 256]
    ia = jnp.asarray(pairs[:, 0])
    ib = jnp.asarray(pairs[:, 1])
    bits = (v[:, ia] < v[:, ib]).astype(jnp.uint32)             # static take
    bits = bits.reshape(-1, DESC_WORDS, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Popcount Hamming distance between packed descriptors.

    a [..., 8] uint32, b [..., 8] uint32 (broadcastable) -> [...] int32.
    (The reference's DBoW2 FORB::distance popcount, thirdparty
    DBoW2/DBoW2/FORB.cpp:81-101, vectorized.)
    """
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(_popcount32(x), axis=-1).astype(jnp.int32)


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """Bit-twiddling popcount for uint32 arrays (SWAR)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def match_brute_force(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
                      valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                      max_dist_abs: int = 30, ratio_vs_min: float = 2.0):
    """Brute-force Hamming matching with the reference's acceptance rule.

    Mirrors LoopClosing::MatchFeatures (reference src/ssvio/loopclosing.cpp:
    105-145): keep a->b nearest matches with d <= max(ratio*min_d, abs_th),
    deduped by enforcing mutual consistency (array analog of the pair-dedupe).

    Returns (idx_b [Na] int32, dist [Na] int32, ok [Na] bool).
    """
    # distance matrix via popcount over broadcast XOR: [Na, Nb]
    d = hamming_distance(desc_a[:, None, :], desc_b[None, :, :])
    big = jnp.int32(512)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, big)
    idx_b = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    min_d = jnp.min(jnp.where(best < big, best, big))
    thresh = jnp.maximum((ratio_vs_min * min_d).astype(jnp.int32),
                         jnp.int32(max_dist_abs))
    # mutual check: b's best must point back at a
    back = jnp.argmin(d, axis=0).astype(jnp.int32)        # [Nb]
    mutual = back[idx_b] == jnp.arange(d.shape[0], dtype=jnp.int32)
    ok = (best <= thresh) & (best < big) & mutual & valid_a
    return idx_b, best.astype(jnp.int32), ok

"""Device-resident map state: SLAM-as-tensors.

Capability parity with the reference's Map class
(reference src/ssvio/map.cpp, include/ssvio/map.hpp:19-83): a fixed-size
ACTIVE window of keyframes plus the active landmarks they observe, with
window eviction by the reference's distance heuristic
(map.cpp:89-140: evict the nearest KF if its distance to the newest is
< 0.2, else the farthest) and garbage collection of landmarks that lose all
active observations (map.cpp:142-160).

Array-form redesign: instead of hash maps of ref-counted objects guarded by
mutexes, the active map is a set of fixed-capacity arrays —
keyframe slots `[W]`, landmark slots `[M]`, and a dense observation table
`[M, W, C]` (C = left/right eye) that IS the BA problem layout (ops/ba
consumes it directly, no graph building step). Slot allocation, eviction
and GC are masked scatter/argsort ops that jit once. The unbounded global
map (all keyframes ever, for PGO/loop closing) lives on the host in numpy —
only the active window does device work per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ssvio_tpu.ops import se3


class MapState(NamedTuple):
    """Active-window map. W = kf slot capacity, M = landmark capacity."""
    kf_pose: jnp.ndarray     # [W, 3, 4] T_cw
    kf_gid: jnp.ndarray      # [W] int32 global keyframe id (-1 = empty)
    kf_valid: jnp.ndarray    # [W] bool
    lm_pos: jnp.ndarray      # [M, 3]
    lm_valid: jnp.ndarray    # [M] bool
    lm_gid: jnp.ndarray      # [M] int32 global landmark id (-1 = empty)
    lm_first_kf: jnp.ndarray # [M] int32 global KF id of first observation
    obs_uv: jnp.ndarray      # [M, W, 2, 2]
    obs_valid: jnp.ndarray   # [M, W, 2]
    next_lm_gid: jnp.ndarray # [] int32 monotonic landmark id counter
    next_kf_gid: jnp.ndarray # [] int32 monotonic keyframe id counter


def empty_map(window: int, max_landmarks: int) -> MapState:
    W, M = window, max_landmarks
    return MapState(
        kf_pose=jnp.broadcast_to(se3.identity(), (W, 3, 4)),
        kf_gid=jnp.full((W,), -1, jnp.int32),
        kf_valid=jnp.zeros((W,), bool),
        lm_pos=jnp.zeros((M, 3), jnp.float32),
        lm_valid=jnp.zeros((M,), bool),
        lm_gid=jnp.full((M,), -1, jnp.int32),
        lm_first_kf=jnp.full((M,), -1, jnp.int32),
        obs_uv=jnp.zeros((M, W, 2, 2), jnp.float32),
        obs_valid=jnp.zeros((M, W, 2), bool),
        next_lm_gid=jnp.int32(0),
        next_kf_gid=jnp.int32(0),
    )


def _choose_evict_slot(m: MapState, new_pose: jnp.ndarray,
                       dist_th: float = 0.2) -> jnp.ndarray:
    """Reference eviction heuristic (map.cpp:89-140): among valid slots,
    nearest-to-new if its distance < dist_th else farthest-from-new."""
    centers = se3.translation(se3.inverse(m.kf_pose))          # [W, 3]
    new_center = se3.translation(se3.inverse(new_pose))
    d = jnp.linalg.norm(centers - new_center[None], axis=-1)
    big = jnp.float32(1e9)
    d_valid = jnp.where(m.kf_valid, d, big)
    near = jnp.argmin(d_valid)
    d_far = jnp.where(m.kf_valid, d, -big)
    far = jnp.argmax(d_far)
    return jnp.where(d_valid[near] < dist_th, near, far).astype(jnp.int32)


@jax.jit
def insert_keyframe(m: MapState, T_cw: jnp.ndarray,
                    feat_lm_slot: jnp.ndarray,   # [N] int32 landmark slot per feature (-1 none)
                    feat_uv_l: jnp.ndarray,      # [N, 2]
                    feat_uv_r: jnp.ndarray,      # [N, 2]
                    feat_has_r: jnp.ndarray,     # [N] bool
                    feat_valid: jnp.ndarray,     # [N] bool
                    ) -> Tuple[MapState, jnp.ndarray, jnp.ndarray]:
    """Insert a keyframe: pick a slot (evicting per heuristic if full),
    register this KF's observations of existing landmarks, GC landmarks
    that lost all active observations.

    Returns (new_map, kf_slot, kf_gid).
    """
    W = m.kf_valid.shape[0]
    any_free = ~jnp.all(m.kf_valid)
    free_slot = jnp.argmin(m.kf_valid.astype(jnp.int32)).astype(jnp.int32)
    evict_slot = _choose_evict_slot(m, T_cw)
    slot = jnp.where(any_free, free_slot, evict_slot)

    # clear the slot's old observations (eviction; no-op for a free slot)
    obs_valid = m.obs_valid.at[:, slot, :].set(False)

    kf_gid = m.next_kf_gid
    kf_pose = m.kf_pose.at[slot].set(T_cw)
    kf_gid_arr = m.kf_gid.at[slot].set(kf_gid)
    kf_valid = m.kf_valid.at[slot].set(True)

    # register observations: scatter feature uv into obs[lm_slot, slot, eye].
    # Features WITHOUT a landmark are routed to row M (out of bounds):
    # JAX drops OOB scatters entirely. Routing them to row 0 instead would
    # race real observations of landmark 0 under duplicate-index scatter
    # (nondeterministic winner) — measured as million-chi2 poison edges
    # that capsized the whole local BA.
    M = m.lm_valid.shape[0]
    has_lm = feat_valid & (feat_lm_slot >= 0)
    safe_slot = jnp.where(has_lm, feat_lm_slot, M)
    safe_r = jnp.where(has_lm & feat_has_r, feat_lm_slot, M)
    obs_uv = m.obs_uv.at[safe_slot, slot, 0].set(feat_uv_l, mode="drop")
    obs_uv = obs_uv.at[safe_r, slot, 1].set(feat_uv_r, mode="drop")
    obs_valid = obs_valid.at[safe_slot, slot, 0].set(True, mode="drop")
    obs_valid = obs_valid.at[safe_r, slot, 1].set(True, mode="drop")

    # GC: landmarks with zero active observations leave the active map
    # (reference RemoveOldActiveMapPoints, map.cpp:142-160)
    lm_active = jnp.any(obs_valid, axis=(1, 2))
    lm_valid = m.lm_valid & lm_active

    return m._replace(kf_pose=kf_pose, kf_gid=kf_gid_arr, kf_valid=kf_valid,
                      obs_uv=obs_uv, obs_valid=obs_valid, lm_valid=lm_valid,
                      next_kf_gid=kf_gid + 1), slot, kf_gid


@jax.jit
def add_landmarks(m: MapState, kf_slot: jnp.ndarray, kf_gid: jnp.ndarray,
                  p_w: jnp.ndarray,        # [K, 3] new landmark positions
                  uv_l: jnp.ndarray,       # [K, 2] observing uv (this KF)
                  uv_r: jnp.ndarray,       # [K, 2]
                  has_r: jnp.ndarray,      # [K] bool
                  new_valid: jnp.ndarray,  # [K] bool
                  ) -> Tuple[MapState, jnp.ndarray]:
    """Allocate landmark slots for newly triangulated points and register
    their first observation. Returns (new_map, lm_slot [K] int32, -1 if not
    allocated)."""
    M = m.lm_valid.shape[0]
    K = p_w.shape[0]
    # rank free slots: argsort puts False (0 = free) first; stable
    free_order = jnp.argsort(m.lm_valid.astype(jnp.int32), stable=True)
    n_free = jnp.sum(~m.lm_valid)
    want_rank = jnp.cumsum(new_valid.astype(jnp.int32)) - 1   # [K]
    can = new_valid & (want_rank < n_free) & (want_rank < M)
    slot = jnp.where(can, free_order[jnp.clip(want_rank, 0, M - 1)], -1)

    # unallocated entries go to row M: OOB scatters are dropped (see
    # insert_keyframe — routing them to row 0 races real row-0 writes)
    safe = jnp.where(can, slot, M)
    safe_r = jnp.where(can & has_r, slot, M)
    gids = m.next_lm_gid + want_rank
    lm_pos = m.lm_pos.at[safe].set(p_w, mode="drop")
    lm_valid = m.lm_valid.at[safe].set(True, mode="drop")
    lm_gid = m.lm_gid.at[safe].set(gids, mode="drop")
    lm_first = m.lm_first_kf.at[safe].set(kf_gid, mode="drop")
    obs_uv = m.obs_uv.at[safe, kf_slot, 0].set(uv_l, mode="drop")
    obs_uv = obs_uv.at[safe_r, kf_slot, 1].set(uv_r, mode="drop")
    obs_valid = m.obs_valid.at[safe, kf_slot, 0].set(True, mode="drop")
    obs_valid = obs_valid.at[safe_r, kf_slot, 1].set(True, mode="drop")
    n_new = jnp.sum(can.astype(jnp.int32))
    return m._replace(lm_pos=lm_pos, lm_valid=lm_valid, lm_gid=lm_gid,
                      lm_first_kf=lm_first, obs_uv=obs_uv, obs_valid=obs_valid,
                      next_lm_gid=m.next_lm_gid + n_new), slot


def ba_problem_from_map(m: MapState, fix_oldest: bool = True):
    """View the active map as a LocalBAProblem (zero-copy reinterpretation).

    Landmarks first observed by a keyframe no longer in the window are held
    FIXED (reference backend.cpp:118-126). The oldest in-window KF is fixed
    as gauge anchor (the reference leaves all KFs free and relies on LM
    damping; an explicit anchor gives the same trajectories with better
    conditioning).
    """
    from ssvio_tpu.ops import ba
    window_gids = jnp.where(m.kf_valid, m.kf_gid, jnp.int32(2 ** 30))
    oldest = jnp.argmin(window_gids)
    kf_fixed = jnp.zeros_like(m.kf_valid)
    if fix_oldest:
        kf_fixed = kf_fixed.at[oldest].set(True)
    first_in_window = jnp.any(
        m.lm_first_kf[:, None] == jnp.where(m.kf_valid, m.kf_gid, -2)[None, :],
        axis=1)
    lm_fixed = m.lm_valid & ~first_in_window
    return ba.LocalBAProblem(
        kf_T_cw=m.kf_pose, kf_valid=m.kf_valid, kf_fixed=kf_fixed,
        lm_pos=m.lm_pos, lm_valid=m.lm_valid, lm_fixed=lm_fixed,
        obs_uv=m.obs_uv, obs_valid=m.obs_valid)


@jax.jit
def apply_ba_result(m: MapState, kf_T_cw: jnp.ndarray, lm_pos: jnp.ndarray,
                    obs_valid: jnp.ndarray) -> MapState:
    """Write back BA results; landmarks that lost every observation to
    outlier detachment leave the active map (reference backend.cpp:207-244)."""
    lm_active = jnp.any(obs_valid, axis=(1, 2))
    return m._replace(kf_pose=kf_T_cw, lm_pos=lm_pos, obs_valid=obs_valid,
                      lm_valid=m.lm_valid & lm_active)

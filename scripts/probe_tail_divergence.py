"""Bisect the lap-3 health divergence: drive the 5-lap repro to frame 250
(loop closing live, like the failing run), snapshot the full live state,
then run frames 250-400 several times with different loop-closing actions
enabled. Whichever action makes the tail's health fall below the frozen
tail's is the degrader (r5 loop investigation)."""

import copy
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ssvio_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=2.0)

import sys

import numpy as np


from scripts.repro_loop5 import small_settings
from ssvio_tpu.dataio import synthetic
from ssvio_tpu.system import System

s = small_settings()
n = 120
world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
circ = synthetic.loop_trajectory(n, radius=6.0)
poses = np.concatenate([circ] * 4, axis=0)
L, R = synthetic.render_stereo_sequence(
    world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
    s.cam_left.cy, s.baseline, s.image_width, s.image_height)

CH = 10
CUT = 250
sys_ = System(s, enable_backend=True, enable_loop_closing=True)
pending = None
for c in range(0, CUT, CH):
    h = sys_.dispatch_chunk(L[c:c + CH], R[c:c + CH])
    if pending is not None:
        sys_.collect_chunk(pending)
    pending = h
sys_.collect_chunk(pending)
sys_.finish()
print("state at cut: n_loops =", sys_.stats["n_loops"],
      "health =", sys_.track_health)

SNAP_KEYS = ["map", "feat", "T_cw", "rel_motion", "last_pyr", "_status",
             "_status_dev", "frame_id", "track_health",
             "track_health_typical"]
snap = {k: getattr(sys_, k) for k in SNAP_KEYS}
snap["_health_window"] = list(sys_._health_window)
snap["_health_history"] = list(sys_._health_history)
snap["_gauge_events"] = list(sys_._gauge_events)
snap["keyframes"] = copy.deepcopy(sys_.keyframes)
snap["kf_rel_edges"] = list(sys_.kf_rel_edges)
snap["stats"] = copy.deepcopy(sys_.stats)
lc = sys_.loopclosing
# the ingest jits DONATE the database arrays, so snapshot host copies and
# re-upload at each restore (a bare reference would be a deleted buffer)
LC_DEV_KEYS = ["bow_db", "desc_db", "desc_valid", "kp_xy", "lm_pos",
               "lm_has", "lm_gid_db", "db_gid_dev", "n_dev"]
LC_KEYS = ["n", "cap", "last_closed_gid", "_residual_anchor"]
lc_snap = {k: getattr(lc, k) for k in LC_KEYS}
lc_dev_snap = {k: np.asarray(getattr(lc, k)) for k in LC_DEV_KEYS}
lc_snap["db_gid"] = lc.db_gid.copy()
lc_snap["row_of_gid"] = dict(lc.row_of_gid)
lc_snap["loop_edges"] = list(lc.loop_edges)
lc_snap["events"] = list(lc.events)
lc_snap["_rng_key"] = lc._rng_key
lc_snap["_large_hist"] = list(getattr(lc, "_large_hist", []))


def restore():
    for k in SNAP_KEYS:
        setattr(sys_, k, snap[k])
    sys_._health_window = list(snap["_health_window"])
    sys_._health_history = list(snap["_health_history"])
    sys_._gauge_events = list(snap["_gauge_events"])
    sys_.keyframes = copy.deepcopy(snap["keyframes"])
    sys_._rec_by_gid = {r["gid"]: r for r in sys_.keyframes}
    sys_.kf_rel_edges = list(snap["kf_rel_edges"])
    sys_.stats = copy.deepcopy(snap["stats"])
    sys_._kf_cache = None
    import jax.numpy as jnp
    for k in LC_KEYS:
        setattr(lc, k, lc_snap[k])
    for k in LC_DEV_KEYS:
        setattr(lc, k, jnp.asarray(lc_dev_snap[k]))
    lc.db_gid = lc_snap["db_gid"].copy()
    lc.row_of_gid = dict(lc_snap["row_of_gid"])
    lc.loop_edges = list(lc_snap["loop_edges"])
    lc.events = list(lc_snap["events"])
    lc._rng_key = lc_snap["_rng_key"]
    lc._large_hist = list(lc_snap["_large_hist"])
    lc._pending = []
    sys_.loopclosing = lc


def tail(tag, frozen=False, no_pgo=False, no_apply=False):
    restore()
    old_th = lc.s.loop_threshold_higher
    if frozen:
        lc.s = type(lc.s)(**{**lc.s.__dict__})
        lc.s.loop_threshold_higher = 2.0
    old_pgo = lc._pose_graph_optimize
    if no_pgo:
        lc._pose_graph_optimize = lambda system: None
    old_apply = sys_.apply_loop_correction
    old_corr = lc._correct_active
    if no_apply:
        sys_.apply_loop_correction = lambda *a, **k: None
    elif no_apply is None:
        # identity-C variant: the FULL accept path (map swap, fusion,
        # relink, gauge event, refresh) runs, but every rigid transform is
        # the exact identity — isolates "apply mechanics" from "C values"
        import jax.numpy as jnp
        I34 = np.eye(3, 4, dtype=np.float32)
        lc._correct_active = (lambda kf, lm, lv, C:
                              old_corr(kf, lm, lv, jnp.asarray(I34)))
        sys_.apply_loop_correction = (
            lambda loopclosing, m, C, relink=None:
            old_apply(loopclosing, m, I34, relink=relink))
    healths, pend = [], None
    for c in range(CUT, 400, CH):
        h = sys_.dispatch_chunk(L[c:c + CH], R[c:c + CH])
        if pend is not None:
            sys_.collect_chunk(pend)
        pend = h
        healths.append(None if sys_.track_health is None
                       else int(sys_.track_health))
    sys_.collect_chunk(pend)
    lc._pose_graph_optimize = old_pgo
    sys_.apply_loop_correction = old_apply
    lc._correct_active = old_corr
    lc.s = s
    lc.s.loop_threshold_higher = old_th
    print(f"{tag}: healths={healths} n_loops={sys_.stats['n_loops']} "
          f"status={sys_._status}", flush=True)


tail("frozen (no events)      ", frozen=True)
tail("live                    ")
tail("live identity-C apply   ", no_apply=None)

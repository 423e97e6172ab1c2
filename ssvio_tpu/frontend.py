"""Front-end: stereo VO tracking state machine on fixed-shape state.

Capability parity with the reference FrontEnd
(reference src/ssvio/frontend.cpp): the INITING / TRACKING_GOOD /
TRACKING_BAD / LOST state machine (frontend.hpp:25-31), constant-velocity
prior + projection-seeded LK against the last frame (TrackLastFrame,
frontend.cpp:130-182), 4x10 pose-only LM with chi2 gating
(EstimateCurrentPose, :184-300), status thresholds (Track, :94-114),
keyframe creation on TRACKING_BAD with masked re-detection
(DetectFeatures, :302-344), projection-seeded left->right LK
(FindFeaturesInRight, :346-428), stereo triangulation of new features
(TriangulateNewPoints, :496-544) and stereo map initialization
(SteroInit/BuidInitMap, :430-494).

Architecture: the per-frame hot path is ONE jitted function
(`track_step`) over fixed-shape feature arrays; keyframe creation is a
second jitted function. The only host<->device traffic per frame is the
image upload and a scalar (pose + inlier count) readback; the Python layer
does nothing but drive the state machine off that scalar — the reference's
mutexed object graph becomes pure array dataflow.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ssvio_tpu import map as mapmod
from ssvio_tpu.config import Settings
from ssvio_tpu.ops import ba, camera, fast, lk, pyramid, sampling, se3, triangulation

# status codes (reference frontend.hpp:25-31)
INITING, TRACKING_GOOD, TRACKING_BAD, LOST = 0, 1, 2, 3


class Pyr(NamedTuple):
    """Image pyramid + its Sobel gradients, built ONCE per image.

    The gradients are the LK template-side state; caching them here lets
    the forward temporal track (template = last frame), backward FB check
    (template = current frame) and stereo matcher (template = left image)
    share one computation instead of re-deriving them inside every
    lk.track call (= 6 full-image Sobel passes per tracked frame)."""
    levels: Tuple[jnp.ndarray, ...]
    gx: Tuple[jnp.ndarray, ...]
    gy: Tuple[jnp.ndarray, ...]

    @property
    def grads(self):
        return (self.gx, self.gy)


class FeatState(NamedTuple):
    """Current-frame feature set, fixed capacity N.

    `lm_gid` guards against landmark-slot recycling: a feature's link is
    only live while MapState.lm_gid[lm_slot] still equals it. Without the
    generation check, a GC'd slot reused by a new landmark silently
    re-targets every stale feature pointing at it — the new observations
    then poison the BA observation table (measured: catastrophic window
    rotations on circular trajectories)."""
    xy: jnp.ndarray        # [N, 2] (level-0 pixel coords)
    lm_slot: jnp.ndarray   # [N] int32 landmark slot in MapState (-1 none)
    lm_gid: jnp.ndarray    # [N] int32 landmark generation id (-1 none)
    valid: jnp.ndarray     # [N] bool
    octave: jnp.ndarray    # [N] int32 detection octave (0 = base scale)


def empty_feat_state(n: int) -> FeatState:
    return FeatState(xy=jnp.zeros((n, 2), jnp.float32),
                     lm_slot=jnp.full((n,), -1, jnp.int32),
                     lm_gid=jnp.full((n,), -1, jnp.int32),
                     valid=jnp.zeros((n,), bool),
                     octave=jnp.zeros((n,), jnp.int32))


class TrackOut(NamedTuple):
    feat: FeatState
    T_cw: jnp.ndarray
    rel_motion: jnp.ndarray
    n_inliers: jnp.ndarray


class Frontend:
    """Host-side driver owning the jitted steps. Not thread-anything:
    the pipeline is synchronous dataflow (see SURVEY §7.3 'async pipeline
    semantics without threads' — BA is applied between frames)."""

    def __init__(self, settings: Settings, width: int, height: int,
                 real_width: int | None = None, real_height: int | None = None):
        s = settings
        self.s = s
        self.w, self.h = width, height            # padded device dims
        self.rw = real_width or width             # true sensor dims (gates)
        self.rh = real_height or height
        self.n_feat = s.max_features
        self.lk_params = lk.LKParams(window=s.lk_window, levels=s.lk_levels,
                                     iters=s.lk_iters, eps=s.lk_eps)
        # stereo disparities (fx*b/z) are much larger than temporal flow;
        # one extra pyramid level widens the zero-seed basin accordingly
        self.lk_params_stereo = self.lk_params._replace(levels=s.lk_levels + 1)
        # backward FB-check track: full depth. (A 2-level variant was
        # measured 2026-08: it drops enough valid tracks on KITTI-scale
        # flow to trigger 6x more keyframes and worse ATE — the per-level
        # kernel saving is a false economy.)
        self.lk_params_back = self.lk_params
        self.rig = camera.StereoRig.from_settings(s)
        fxl = self.rig.intr_left
        self._fx, self._fy = fxl.fx, fxl.fy
        self._cx, self._cy = fxl.cx, fxl.cy
        self._baseline = self.rig.baseline
        # distortion (plumb bob). The reference undistorts both frames when
        # Camera.NeedUndistortion is set (frontend.cpp:39-45,
        # camera.cpp:43-55); here a per-eye device remap applied before the
        # pyramid build. Skipped entirely when all coefficients are zero.
        self._dist_l = (s.cam_left.k1, s.cam_left.k2,
                        s.cam_left.p1, s.cam_left.p2)
        self._dist_r = (s.cam_right.k1, s.cam_right.k2,
                        s.cam_right.p1, s.cam_right.p2)
        self.need_undistortion = bool(s.need_undistortion) and any(
            c != 0.0 for c in self._dist_l + self._dist_r)

        self.track_step = jax.jit(self._track_step)
        self.keyframe_step = jax.jit(self._keyframe_step,
                                     static_argnames=("min_new_landmarks",
                                                      "budget"))
        self.build_pyramid = jax.jit(self._build_pyramid)
        self.undistort_left = jax.jit(self._undistort_left)
        self.undistort_right = jax.jit(self._undistort_right)
        # standalone detection on a bare frame (relocalization entry: a LOST
        # frame has no surviving feature state to merge with)
        self.detect_features = jax.jit(
            lambda img: self._detect_merge(img, empty_feat_state(self.n_feat))[0])

    # ------------------------------------------------------------------
    def _undistort_left(self, img: jnp.ndarray) -> jnp.ndarray:
        """Image-space undistortion of a left frame (no-op rig: identity).
        The remap grid is a pure function of the static intrinsics so XLA
        constant-folds it (one bilinear gather pass per frame)."""
        if not self.need_undistortion:
            return img
        return camera.undistort_image(self.rig.intr_left, self._dist_l,
                                      img.astype(jnp.float32))

    def _undistort_right(self, img: jnp.ndarray) -> jnp.ndarray:
        if not self.need_undistortion:
            return img
        return camera.undistort_image(self.rig.intr_right, self._dist_r,
                                      img.astype(jnp.float32))

    # ------------------------------------------------------------------
    def _build_pyramid(self, img: jnp.ndarray) -> Pyr:
        img = img.astype(jnp.float32)   # camera-native u8 frames promote here
        levels = pyramid.build_lk_pyramid(img, self.s.lk_levels + 1)
        grads = [pyramid.sobel_gradients(l) for l in levels]
        return Pyr(levels=tuple(levels),
                   gx=tuple(g[0] for g in grads),
                   gy=tuple(g[1] for g in grads))

    # ------------------------------------------------------------------
    def _track_step(self, pyr_last, pyr_cur, feat: FeatState,
                    T_last, rel_motion, lm_pos, lm_valid, lm_gid) -> TrackOut:
        """LK vs last frame (projection-seeded) + pose-only LM + gating."""
        T_guess = se3.compose(rel_motion, T_last)
        lm_idx = jnp.clip(feat.lm_slot, 0, lm_pos.shape[0] - 1)
        has_lm = (feat.valid & (feat.lm_slot >= 0) & lm_valid[lm_idx]
                  & (lm_gid[lm_idx] == feat.lm_gid))
        p_w = lm_pos[lm_idx]
        seed = camera.world2pixel(self.rig.intr_left, T_guess, p_w)
        in_img = sampling.in_bounds(seed, self.rh, self.rw, border=8.0)
        seed = jnp.where((has_lm & in_img)[:, None], seed, feat.xy)

        new_xy, ok, _ = lk.track(pyr_last.levels, pyr_cur.levels, feat.xy,
                                 seed, has_lm, self.lk_params,
                                 compute_err=False, grads_prev=pyr_last.grads)
        # forward-backward gate: a track must return to its origin when
        # tracked back. This breaks the prior-seeded positive feedback where
        # LK "slides" with an overshooting constant-velocity guess on weak
        # texture and the chi2 gate cannot notice (all features slide
        # consistently).
        # backward seed = the landed position itself (zero flow): the
        # reverse track must find its own way home; seeding it with the
        # origin would bias it into agreeing with mislocks.
        xy_back, ok_b, _ = lk.track(pyr_cur.levels, pyr_last.levels, new_xy,
                                    new_xy, has_lm & ok, self.lk_params_back,
                                    compute_err=False, grads_prev=pyr_cur.grads)
        fb = jnp.linalg.norm(xy_back - feat.xy, axis=-1)
        in_real = sampling.in_bounds(new_xy, self.rh, self.rw, border=1.0)
        tracked = has_lm & ok & ok_b & (fb < 0.6) & in_real

        # Optimizer starts from T_LAST, not the extrapolated prior: the
        # reference seeds its g2o solve with the prior (frontend.cpp:196-203)
        # but with Huber + between-round chi2 gating a biased prior can latch
        # (inliers get re-selected around the biased pose each round and the
        # error feeds back through rel_motion frame after frame — measured
        # 35x worse ATE on the synthetic corridor). The prior still seeds LK
        # above, which is where it genuinely helps.
        res = ba.pose_only_optimize(T_last, p_w, new_xy, tracked,
                                    self._fx, self._fy, self._cx, self._cy)
        # keep tracked features; drop pose-BA outliers (the reference flags
        # their mappoints as outliers, frontend.cpp:283-294 — our GC happens
        # at the map level when observations disappear)
        feat_out = FeatState(xy=new_xy, lm_slot=feat.lm_slot,
                             lm_gid=feat.lm_gid, valid=tracked & res.inlier,
                             octave=feat.octave)
        rel = se3.compose(res.T_cw, se3.inverse(T_last))
        return TrackOut(feat_out, res.T_cw, rel, res.n_inliers)

    # ------------------------------------------------------------------
    def _detect_merge(self, img, feat: FeatState, max_new_per_cell: int = 4,
                      budget: int | None = None):
        """Masked re-detection + compaction merge into the fixed feature set.

        Existing valid features are compacted to the front; fresh FAST
        detections (blocked within +-10 px of existing ones,
        reference frontend.cpp:304-312) fill the remaining slots.
        Detection is scale-covariant: per-octave FAST over the 1.2^L
        geometric pyramid with coordinates mapped to level 0 and the octave
        recorded per feature (reference ComputeKeyPointsOctTree,
        orbextractor.cpp:572-676; set Settings.detect_octaves=1 for the old
        single-scale behavior).

        `budget` caps the number of NEW detections accepted (detections are
        response-ranked, so the budget keeps the strongest) — the array form
        of the reference's two extractors (300-feature init / 100-feature
        steady, system.cpp:115-129): one detector, a per-call budget.
        Returns (FeatState, is_new [N] bool).
        """
        N = self.n_feat
        occ = fast.build_occupancy(self.h, self.w, feat.xy, feat.valid, radius=10)
        # block the padding margins too
        yy = jax.lax.broadcasted_iota(jnp.int32, (self.h, self.w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (self.h, self.w), 1)
        border = (xx < 16) | (xx >= self.rw - 16) | (yy < 16) | (yy >= self.rh - 16)
        n_oct = self.s.detect_octaves or self.s.n_levels
        if n_oct > 1:
            orb_pyr = pyramid.build_orb_pyramid(img, n_oct,
                                                self.s.scale_factor)
            det_xy, det_resp, det_oct, det_valid = fast.detect_multiscale(
                orb_pyr, self.s.scale_factor, max_kps=N,
                cell=self.s.grid_cell,
                ini_threshold=float(self.s.ini_th_fast),
                min_threshold=float(self.s.min_th_fast),
                occupancy=occ | border, kps_per_cell=max_new_per_cell)
        else:
            det_xy, det_resp, det_valid = fast.detect_grid(
                img, max_kps=N, cell=self.s.grid_cell,
                ini_threshold=float(self.s.ini_th_fast),
                min_threshold=float(self.s.min_th_fast),
                occupancy=occ | border, kps_per_cell=max_new_per_cell)
            det_oct = jnp.zeros((N,), jnp.int32)

        order = jnp.argsort(~feat.valid, stable=True)     # valid first
        ex_xy = feat.xy[order]
        ex_lm = feat.lm_slot[order]
        ex_gid = feat.lm_gid[order]
        ex_oct = feat.octave[order]
        ex_valid = feat.valid[order]
        n_exist = jnp.sum(ex_valid.astype(jnp.int32))
        slot_idx = jnp.arange(N, dtype=jnp.int32)
        # new detection k goes to slot n_exist + k
        new_rank = slot_idx - n_exist                      # per-slot: which new det
        # budget may be a python int (static) or a traced scalar (the
        # engine's unified keyframe branch selects init vs steady budget
        # dynamically so the branch is traced ONCE)
        cap = N if budget is None else jnp.minimum(budget, N)
        take_new = (new_rank >= 0) & (new_rank < cap) & ~ex_valid
        new_idx = jnp.clip(new_rank, 0, N - 1)
        new_ok = take_new & det_valid[new_idx]
        xy = jnp.where(new_ok[:, None], det_xy[new_idx], ex_xy)
        lm_slot = jnp.where(new_ok, -1, jnp.where(ex_valid, ex_lm, -1))
        lm_gid = jnp.where(new_ok, -1, jnp.where(ex_valid, ex_gid, -1))
        octave = jnp.where(new_ok, det_oct[new_idx],
                           jnp.where(ex_valid, ex_oct, 0))
        valid = ex_valid | new_ok
        return FeatState(xy=xy, lm_slot=lm_slot, lm_gid=lm_gid,
                         valid=valid, octave=octave), new_ok

    # ------------------------------------------------------------------
    def _stereo_match(self, pyr_l, pyr_r, feat: FeatState, T_cw, lm_pos,
                      lm_gid):
        """Left->right LK, projection-seeded where a landmark exists
        (reference FindFeaturesInRight, frontend.cpp:346-428)."""
        lm_idx = jnp.clip(feat.lm_slot, 0, lm_pos.shape[0] - 1)
        has_lm = (feat.valid & (feat.lm_slot >= 0)
                  & (lm_gid[lm_idx] == feat.lm_gid))
        p_cl = se3.transform(T_cw, lm_pos[lm_idx])
        p_cr = p_cl + jnp.stack([-jnp.broadcast_to(self._baseline, p_cl[..., 0].shape),
                                 jnp.zeros_like(p_cl[..., 0]),
                                 jnp.zeros_like(p_cl[..., 0])], axis=-1)
        seed = camera.camera2pixel(self.rig.intr_right, p_cr)
        in_img = sampling.in_bounds(seed, self.rh, self.rw, border=8.0)
        seed = jnp.where((has_lm & in_img)[:, None], seed, feat.xy)
        xy_r, ok, err = lk.track(pyr_l.levels, pyr_r.levels, feat.xy, seed,
                                 feat.valid, self.lk_params_stereo,
                                 grads_prev=pyr_l.grads)
        # forward-backward consistency: re-track right->left and demand the
        # round trip lands within 0.6 px. Kills the repetitive-texture
        # mislocks that otherwise produce systematically-deep triangulations
        # (weak new corners are especially prone; the reference relies on
        # per-feature chi2 gating downstream, which cannot catch a
        # consistent mislock).
        xy_back, ok_b, _ = lk.track(pyr_r.levels, pyr_l.levels, xy_r, xy_r,
                                    ok & feat.valid, self.lk_params_stereo,
                                    compute_err=False, grads_prev=pyr_r.grads)
        fb = jnp.linalg.norm(xy_back - feat.xy, axis=-1)
        # rectified epipolar sanity: |dy| small, disparity positive
        dy = jnp.abs(xy_r[:, 1] - feat.xy[:, 1])
        disp = feat.xy[:, 0] - xy_r[:, 0]
        ok = ok & ok_b & (fb < 0.6) & feat.valid & (dy < 2.0) & (disp > 0.1) \
            & (err < 25.0)
        return xy_r, ok

    # ------------------------------------------------------------------
    def _keyframe_step(self, pyr_l, pyr_r, feat: FeatState, T_cw,
                       m: mapmod.MapState, min_new_landmarks: int = 0,
                       budget: int | None = None):
        """Re-detect, stereo-match, triangulate new landmarks, insert KF.

        `budget` caps the NEW detections (init vs steady extractor parity
        — see _detect_merge).
        Returns (feat', map', kf_slot, kf_gid, n_landmarks_created,
        n_stereo) where n_stereo counts stereo-matched features (the
        reference's init_good gate input, frontend.cpp:433-437).
        """
        feat2, is_new = self._detect_merge(pyr_l.levels[0], feat,
                                           budget=budget)
        # generation check: a stale slot link (GC'd + recycled landmark)
        # must not register observations of the new occupant
        lm_idx2 = jnp.clip(feat2.lm_slot, 0, m.lm_pos.shape[0] - 1)
        link_live = (feat2.lm_slot >= 0) & (m.lm_gid[lm_idx2] == feat2.lm_gid) \
            & m.lm_valid[lm_idx2]
        feat2 = feat2._replace(
            lm_slot=jnp.where(link_live, feat2.lm_slot, -1),
            lm_gid=jnp.where(link_live, feat2.lm_gid, -1))
        xy_r, has_r = self._stereo_match(pyr_l, pyr_r, feat2, T_cw, m.lm_pos,
                                         m.lm_gid)

        # triangulate NEW features with a right match in the current camera
        # frame, then lift to world through T_cw^-1
        p_cam, tri_ok = triangulation.triangulate_stereo_rectified(
            feat2.xy, xy_r, self._fx, self._fy, self._cx, self._cy,
            self._baseline, min_disparity=0.5)
        max_z = self.s.max_depth_factor * float(self.s.baseline)
        depth_ok = (p_cam[:, 2] > 0.5) & (p_cam[:, 2] < max_z)
        new_lm = is_new & has_r & tri_ok & depth_ok
        p_w = camera.camera2world(T_cw, p_cam)

        m2, kf_slot, kf_gid = mapmod.insert_keyframe(
            m, T_cw, feat2.lm_slot, feat2.xy, xy_r, has_r, feat2.valid)
        m3, lm_slots = mapmod.add_landmarks(
            m2, kf_slot, kf_gid, p_w, feat2.xy, xy_r, has_r, new_lm)
        new_gid = m3.lm_gid[jnp.clip(lm_slots, 0, m3.lm_gid.shape[0] - 1)]
        feat3 = FeatState(xy=feat2.xy,
                          lm_slot=jnp.where(lm_slots >= 0, lm_slots, feat2.lm_slot),
                          lm_gid=jnp.where(lm_slots >= 0, new_gid, feat2.lm_gid),
                          valid=feat2.valid & ((feat2.lm_slot >= 0) | (lm_slots >= 0)),
                          octave=feat2.octave)
        n_created = jnp.sum((lm_slots >= 0).astype(jnp.int32))
        n_stereo = jnp.sum(has_r.astype(jnp.int32))
        return feat3, m3, kf_slot, kf_gid, n_created, n_stereo

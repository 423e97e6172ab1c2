"""Device-resident chunked engine: N frames per dispatch via lax.scan.

The reference pipelines its per-frame work across four POSIX threads and
pays a mutex-guarded object graph for it (reference src/ssvio/frontend.cpp,
backend.cpp — see SURVEY §2.3). The array-form equivalent is to make the
whole per-frame step — pyramid build, seeded LK, pose-only LM, the
tracking-status state machine, keyframe insertion, stereo triangulation,
and sliding-window BA — a single compiled program, and to scan it over a
CHUNK of frames so host<->device latency (dispatch + pose readback) is
paid once per chunk instead of several times per frame:

    carry = (pyramid of last frame, feature set, pose, rel motion,
             map window, status)
    carry, per_frame_outputs = lax.scan(step, carry, (imgs_l, imgs_r))

Control flow that is data-dependent in the reference (state machine
switch, keyframe trigger) becomes lax.switch / lax.cond ON DEVICE
(reference FrontEnd::GrabSteroImage dispatches on status_ on the host
thread, frontend.cpp:49-67; Backend::OptimizeActiveMap runs on its own
thread, backend.cpp:78-245 — here the BA rides the keyframe branch of the
same program). The host reads back only [K] poses + status/keyframe flags
per chunk and drives loop closing for the (rare) flagged frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ssvio_tpu import frontend as fe
from ssvio_tpu import map as mapmod
from ssvio_tpu.ops import ba, se3


class EngineCarry(NamedTuple):
    """Everything the per-frame step needs from the previous frame."""
    pyr_last: Tuple[jnp.ndarray, ...]
    feat: fe.FeatState
    T_cw: jnp.ndarray        # [3, 4]
    rel_motion: jnp.ndarray  # [3, 4]
    m: mapmod.MapState
    status: jnp.ndarray      # [] int32 (fe.INITING/TRACKING_GOOD/BAD/LOST)


class FrameOut(NamedTuple):
    """Per-frame scan outputs. Scalars are read back each chunk; `feat`
    stays on device and is sliced only for keyframe frames (loop closing).
    `desc`/`dval` are the loop-closing descriptor ladder for keyframe
    frames, computed INSIDE the chunk program (zeros-sized when the engine
    was built with loop_desc=False): the separate describe dispatch +
    host-latency round trips cost more than the compute (PERF.md r4)."""
    T_cw: jnp.ndarray        # [3, 4] post-BA pose of the frame
    status: jnp.ndarray      # [] int32 status AFTER this frame
    n_inliers: jnp.ndarray   # [] int32
    kf_flag: jnp.ndarray     # [] bool — a keyframe was inserted this frame
    kf_slot: jnp.ndarray     # [] int32 window slot of that keyframe
    kf_gid: jnp.ndarray      # [] int32 global id of that keyframe
    feat: fe.FeatState       # feature state after the frame (device-side)
    desc: jnp.ndarray        # [S*F, 8] uint32 loop descriptors (or [0, 8])
    dval: jnp.ndarray        # [S*F] bool (or [0])


def _sel(pred, a, b):
    """Pytree-wide where(pred, a, b) with rank broadcasting."""
    def one(x, y):
        p = jnp.reshape(pred, (1,) * x.ndim) if x.ndim else pred
        return jnp.where(p, x, y)
    return jax.tree.map(one, a, b)


class Engine:
    """Owns the jitted chunk program. Stateless apart from compile caches;
    all SLAM state lives in the EngineCarry the caller threads through.

    `mesh`: optional jax.sharding.Mesh with a 'lm' axis. When set, the
    landmark-indexed map arrays (positions, validity, the [M, W, 2]
    observation table) are sharding-constrained over that axis INSIDE the
    chunk program, so GSPMD partitions the BA linearization/Schur
    reduction across devices and inserts the collectives (psum of the
    [W,6,6] pose blocks) automatically — the engine-integrated form of
    parallel/dist_ba's explicit shard_map path (SURVEY §2.3; BASELINE
    configs 4-5). Tracking gathers stay replicated (they touch ~N of M
    rows per frame)."""

    def __init__(self, frontend: fe.Frontend, enable_backend: bool,
                 mesh=None, loop_desc: bool = False):
        self.fe = frontend
        self.s = frontend.s
        self.enable_backend = enable_backend
        self.mesh = mesh
        # loop_desc: keyframe frames emit the loop-closing descriptor
        # ladder as scan outputs (see FrameOut.desc)
        self.loop_desc = loop_desc
        self._desc_rows = (self.s.loop_desc_scales * self.s.max_features
                           if loop_desc else 0)
        self.run_chunk = jax.jit(self._run_chunk)
        self.run_frame = jax.jit(self._step)

    # ------------------------------------------------------------------
    def _lm_sharded(self, m: mapmod.MapState) -> mapmod.MapState:
        """Constrain landmark-axis arrays of the map onto the mesh."""
        if self.mesh is None:
            return m
        from jax.sharding import NamedSharding, PartitionSpec as P
        lm = NamedSharding(self.mesh, P("lm"))
        c = functools.partial(jax.lax.with_sharding_constraint)
        return m._replace(
            lm_pos=c(m.lm_pos, lm), lm_valid=c(m.lm_valid, lm),
            lm_gid=c(m.lm_gid, lm), lm_first_kf=c(m.lm_first_kf, lm),
            obs_uv=c(m.obs_uv, lm), obs_valid=c(m.obs_valid, lm))

    # ------------------------------------------------------------------
    def _step(self, carry: EngineCarry, img_l, img_r):
        """One engine frame. The state machine is expressed as TWO conds
        over shared sub-programs — track (GOOD/BAD) and keyframe machinery
        (INITING + TRACKING_BAD share one trace, with the init/steady
        detection budget and acceptance selected dynamically) — instead of
        a 3-way lax.switch duplicating the detection/stereo/triangulation
        HLO per branch: tracing the keyframe machinery once roughly halves
        the program and its compile time.

        Reference: FrontEnd::GrabSteroImage status dispatch
        (frontend.cpp:49-67), SteroInit (:430-446), Track (:79-128),
        InsertKeyFrame (:546-576) + Backend::OptimizeActiveMap
        (backend.cpp:78-245) — thread handoffs there, cond branches of one
        program here. LOST dead-ends (reference frontend.cpp:62-66 TODO);
        recovery is a host decision between chunks."""
        f = self.fe
        s = self.s
        # images may arrive as uint8 (camera-native; 4x fewer bytes to
        # upload) — promote on device. Undistortion (when
        # configured) runs before the pyramid build, like the reference's
        # per-frame UndistortImage (frontend.cpp:39-45); the right eye is
        # undistorted lazily inside the keyframe branch (its pyramid is
        # only needed there).
        img_l = f._undistort_left(img_l.astype(jnp.float32))
        img_r = img_r.astype(jnp.float32)
        pyr_l = f._build_pyramid(img_l)
        status = carry.status
        is_init = status == fe.INITING
        is_track = ((status == fe.TRACKING_GOOD)
                    | (status == fe.TRACKING_BAD))

        # ---- tracking (only for GOOD/BAD; INITING/LOST pass through)
        def do_track(c: EngineCarry):
            out = f._track_step(c.pyr_last, pyr_l, c.feat, c.T_cw,
                                c.rel_motion, c.m.lm_pos, c.m.lm_valid,
                                c.m.lm_gid)
            st = jnp.where(
                out.n_inliers > s.tracking_good, jnp.int32(fe.TRACKING_GOOD),
                jnp.where(out.n_inliers > s.tracking_bad,
                          jnp.int32(fe.TRACKING_BAD), jnp.int32(fe.LOST)))
            return out, st

        def no_track(c: EngineCarry):
            return fe.TrackOut(c.feat, c.T_cw, c.rel_motion,
                               jnp.int32(0)), c.status

        out, status_t = jax.lax.cond(is_track, do_track, no_track, carry)
        need_kf = is_init | (is_track & (status_t == fe.TRACKING_BAD))

        # ---- keyframe machinery (ONE trace for init + steady)
        def do_kf(_):
            pyr_r = f._build_pyramid(f._undistort_right(img_r))
            empty = fe.empty_feat_state(s.max_features)
            feat_in = _sel(is_init, empty, out.feat)
            T_in = _sel(is_init, se3.identity(), out.T_cw)
            # init vs steady extractor budget (reference system.cpp:115-129)
            budget = jnp.where(is_init, s.n_init_features, s.n_new_features)
            feat2, m2, kf_slot, kf_gid, n_created, n_stereo = \
                f._keyframe_step(pyr_l, pyr_r, feat_in, T_in, carry.m,
                                 budget=budget)
            # init gates: enough stereo-matched features (init_good,
            # reference frontend.cpp:433-437) AND enough triangulated
            # landmarks (Min.Init.Landmark.Num, :452-488)
            init_ok = ((n_created >= s.min_init_landmarks)
                       & (n_stereo >= s.init_good))
            accept = jnp.where(is_init, init_ok, True)
            if self.loop_desc:
                from ssvio_tpu.loopclosing import (loop_describe,
                                                   pattern_from_settings)
                desc, dval = loop_describe(
                    img_l, feat2.xy, feat2.valid, s.loop_desc_scales,
                    s.scale_factor,
                    screen_threshold=(s.min_th_fast if s.loop_screen_fast
                                      else 0.0),
                    pattern=pattern_from_settings(s))
            else:
                desc = jnp.zeros((0, 8), jnp.uint32)
                dval = jnp.zeros((0,), bool)
            T2 = T_in
            if self.enable_backend:
                # sliding-window BA rides steady keyframes only (the
                # reference backend starts after init too)
                def run_ba(args):
                    m_in, T = args
                    prob = mapmod.ba_problem_from_map(self._lm_sharded(m_in))
                    res = ba.local_ba(prob, f._fx, f._fy, f._cx, f._cy,
                                      f._baseline)
                    m_out = mapmod.apply_ba_result(m_in, res.kf_T_cw,
                                                   res.lm_pos, res.obs_valid)
                    return m_out, m_out.kf_pose[kf_slot]

                m2, T2 = jax.lax.cond(jnp.logical_not(is_init), run_ba,
                                      lambda a: a, (m2, T2))
            return accept, feat2, m2, kf_slot, kf_gid, T2, desc, dval

        def no_kf(_):
            return (jnp.asarray(False), out.feat, carry.m, jnp.int32(-1),
                    jnp.int32(-1), out.T_cw,
                    jnp.zeros((self._desc_rows if self.loop_desc else 0, 8),
                              jnp.uint32),
                    jnp.zeros((self._desc_rows if self.loop_desc else 0,),
                              bool))

        accept, feat2, m2, kf_slot, kf_gid, T2, desc, dval = jax.lax.cond(
            need_kf, do_kf, no_kf, None)
        kf_ok = need_kf & accept

        # ---- compose the post-frame state (init reject reverts)
        feat_f = _sel(kf_ok, feat2, out.feat)
        m_f = _sel(kf_ok, m2, carry.m)
        T_f = _sel(kf_ok, T2, out.T_cw)
        rel_f = _sel(is_init & kf_ok, se3.identity(), out.rel_motion)
        status_f = jnp.where(
            is_init, jnp.where(kf_ok, jnp.int32(fe.TRACKING_GOOD),
                               jnp.int32(fe.INITING)), status_t)
        c2 = EngineCarry(pyr_l, feat_f, T_f, rel_f, m_f, status_f)
        return c2, FrameOut(T_cw=T_f, status=status_f,
                            n_inliers=out.n_inliers, kf_flag=kf_ok,
                            kf_slot=jnp.where(kf_ok, kf_slot, -1),
                            kf_gid=jnp.where(kf_ok, kf_gid, -1),
                            feat=feat_f, desc=desc, dval=dval)

    # ------------------------------------------------------------------
    def _run_chunk(self, carry: EngineCarry, imgs_l, imgs_r):
        """Scan the per-frame step over [K, H, W] stereo stacks — ONE
        dispatch per chunk, ~16 scalars + one pose per frame read back."""
        def step(c, xy):
            return self._step(c, xy[0], xy[1])
        carry, outs = jax.lax.scan(step, carry, (imgs_l, imgs_r))
        return carry, outs, pack_readback(carry, outs)


PER_FRAME_PACK = 17          # 12 pose + status + n_inliers + kf_flag/slot/gid


def pack_readback(carry: EngineCarry, outs: FrameOut) -> jnp.ndarray:
    """Flatten everything the host needs per chunk into ONE f32 vector so
    the host does a single device->host fetch instead of one per field.
    Layout:

      [K*17]  per frame: T_cw (12) | status | n_inliers | kf_flag | kf_slot
              | kf_gid
      [1]     carry.status after the chunk
      [W]     map.kf_gid   (window keyframe ids, for record refresh)
      [W]     map.kf_valid
      [12W]   map.kf_pose flattened

    int fields ride as f32 (ids stay well under 2^24)."""
    K = outs.T_cw.shape[0]
    f32 = jnp.float32
    per = jnp.concatenate([
        outs.T_cw.reshape(K, 12),
        outs.status[:, None].astype(f32),
        outs.n_inliers[:, None].astype(f32),
        outs.kf_flag[:, None].astype(f32),
        outs.kf_slot[:, None].astype(f32),
        outs.kf_gid[:, None].astype(f32),
    ], axis=1)
    m = carry.m
    tail = jnp.concatenate([
        carry.status[None].astype(f32),
        m.kf_gid.astype(f32),
        m.kf_valid.astype(f32),
        m.kf_pose.reshape(-1),
    ])
    return jnp.concatenate([per.reshape(-1), tail])


def fresh_carry(settings, frontend: fe.Frontend, m: mapmod.MapState
                ) -> EngineCarry:
    """Initial carry: INITING status, zero pyramid placeholder."""
    zero = jnp.zeros((frontend.h, frontend.w), jnp.float32)
    return EngineCarry(
        pyr_last=frontend._build_pyramid(zero),
        feat=fe.empty_feat_state(settings.max_features),
        T_cw=se3.identity(), rel_motion=se3.identity(), m=m,
        status=jnp.int32(fe.INITING))

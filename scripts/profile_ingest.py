"""Profile the batched loop-closing ingest (r4) on the current backend.

Breaks the per-chunk ingest cost into: descriptor ladder (describe), BoW
transform, database scoring, and the full fused _ingest_v dispatch, at
bench scale (512 features, 8 octaves, KITTI resolution). Run on the GPU
(default backend) to attribute the loop-on headline cost.

Usage: python scripts/profile_ingest.py [batch_B]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from ssvio_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def timeit(tag, fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps * 1e3
    print(f"{tag:28s} {dt:8.1f} ms")
    return dt


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import _make_settings
    from ssvio_tpu.loopclosing import LoopClosing
    from ssvio_tpu.ops import bow
    from ssvio_tpu import frontend as fe
    from ssvio_tpu import map as mapmod

    s = _make_settings()
    lc = LoopClosing(s, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
                     s.cam_left.cy)
    H = -(-s.image_height // 16) * 16
    W = -(-s.image_width // 16) * 16
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    imgs = jnp.stack([img] * B)
    F = s.max_features
    xy = jnp.asarray(np.stack([rng.uniform(30, W - 30, F),
                               rng.uniform(30, H - 30, F)], -1)
                     .astype(np.float32))
    xys = jnp.stack([xy] * B)
    valid = jnp.ones((F,), bool)
    valids = jnp.stack([valid] * B)

    print(f"B={B} F={F} scales={lc.S} img={H}x{W} device={jax.devices()[0]}")

    # 1. single describe (8-octave ladder)
    d_desc = timeit("describe x1", lc._describe, img, xy, valid)
    desc, dval = lc._describe(img, xy, valid)

    # 2. vocabulary bits: train a tiny vocab to bench transform/score
    docs = [np.asarray(desc)[np.asarray(dval)][:400] for _ in range(30)]
    lc.vocab = bow.train(docs, k=s.vocab_k, levels=s.vocab_levels, seed=7)
    lc._vocab_levels = s.vocab_levels
    lc.bow_db = jnp.zeros((lc.cap, lc.vocab.n_words), jnp.float32)

    tr = jax.jit(lambda d, dv: bow.transform(lc.vocab, d, dv,
                                             lc._vocab_levels))
    d_tr = timeit("bow transform x1", tr, desc, dval)
    v = tr(desc, dval)
    sc = jax.jit(lambda v: bow.score_l1_database(
        v, lc.bow_db, jnp.ones((lc.cap,), bool)))
    d_sc = timeit("db score x1", sc, v)

    # 3. full fused ingest
    m = mapmod.empty_map(s.max_window, s.max_landmarks)
    feat = fe.empty_feat_state(F)
    slots = jnp.stack([feat.lm_slot] * B)
    fgids = jnp.stack([feat.lm_gid] * B)
    rows_a = jnp.asarray(list(range(B)), jnp.int32)
    gids_a = jnp.asarray([100 + i for i in range(B)], jnp.int32)

    def run_ingest():
        return lc._ingest_v(
            lc.desc_db, lc.desc_valid, lc.kp_xy, lc.lm_pos, lc.lm_has,
            lc.lm_gid_db, lc.bow_db, rows_a, imgs, xys, valids, slots,
            fgids, m.lm_pos, m.lm_gid, m.lm_valid, lc.vocab,
            jnp.asarray(lc.db_gid, jnp.int32), gids_a, jnp.int32(20),
            levels=lc._vocab_levels)

    out = run_ingest()
    (lc.desc_db, lc.desc_valid, lc.kp_xy, lc.lm_pos, lc.lm_has,
     lc.lm_gid_db, lc.bow_db) = out[:7]
    jax.block_until_ready(out[7])
    t0 = time.time()
    reps = 5
    for _ in range(reps):
        out = run_ingest()
        (lc.desc_db, lc.desc_valid, lc.kp_xy, lc.lm_pos, lc.lm_has,
         lc.lm_gid_db, lc.bow_db) = out[:7]
        jax.block_until_ready(out[7])
    d_ing = (time.time() - t0) / reps * 1e3
    print(f"{'fused ingest (B)':28s} {d_ing:8.1f} ms")
    print(f"\nestimate: describe dominates at "
          f"{B * d_desc:.0f} ms/{d_ing:.0f} ms fused")


if __name__ == "__main__":
    main()

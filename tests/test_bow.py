"""Vocabulary training / transform / scoring unit tests (ops/bow.py)."""

import jax.numpy as jnp
import numpy as np

from ssvio_tpu.ops import bow, orb


def _random_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, orb.DESC_WORDS), dtype=np.uint32)


def _perturb(rng, desc, bits):
    """Flip `bits` random bits in each descriptor."""
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(bits):
            w = rng.integers(orb.DESC_WORDS)
            out[i, w] ^= np.uint32(1) << np.uint32(rng.integers(32))
    return out


def test_pack_unpack_roundtrip(rng):
    d = _random_desc(rng, 17)
    assert np.array_equal(bow._pack_bits(bow._unpack_bits(d)), d)


def test_hamming_np_matches_popcount(rng):
    a = _random_desc(rng, 5)
    b = _random_desc(rng, 7)
    d_np = bow._hamming_np(bow._unpack_bits(a), bow._unpack_bits(b))
    d_jax = np.asarray(orb.hamming_distance(
        jnp.asarray(a)[:, None, :], jnp.asarray(b)[None, :, :]))
    assert np.array_equal(d_np, d_jax)


def test_train_and_words(rng):
    """Descriptors near a training cluster map to the same word."""
    protos = _random_desc(rng, 30)
    docs = [_perturb(rng, protos, 8) for _ in range(6)]
    vocab = bow.train(docs, k=5, levels=2, seed=1)
    assert vocab.n_words >= 10

    w_protos = np.asarray(bow.words_of(vocab, jnp.asarray(protos),
                                       jnp.ones(30, bool), 2))
    near = _perturb(rng, protos, 4)
    w_near = np.asarray(bow.words_of(vocab, jnp.asarray(near),
                                     jnp.ones(30, bool), 2))
    assert (w_protos == w_near).mean() > 0.7
    # invalid descriptors get word -1
    w_inv = np.asarray(bow.words_of(vocab, jnp.asarray(protos),
                                    jnp.zeros(30, bool), 2))
    assert (w_inv == -1).all()


def test_transform_scoring_discriminates(rng):
    """Same-scene BoW vectors score far higher than different-scene ones."""
    protos_a = _random_desc(rng, 60)
    protos_b = _random_desc(rng, 60)
    docs = ([_perturb(rng, protos_a, 10) for _ in range(4)]
            + [_perturb(rng, protos_b, 10) for _ in range(4)])
    vocab = bow.train(docs, k=6, levels=2, seed=2)

    va1 = bow.transform(vocab, jnp.asarray(_perturb(rng, protos_a, 5)),
                        jnp.ones(60, bool), 2)
    va2 = bow.transform(vocab, jnp.asarray(_perturb(rng, protos_a, 5)),
                        jnp.ones(60, bool), 2)
    vb = bow.transform(vocab, jnp.asarray(_perturb(rng, protos_b, 5)),
                       jnp.ones(60, bool), 2)
    s_same = float(bow.score_l1(va1, va2))
    s_diff = float(bow.score_l1(va1, vb))
    assert 0.0 <= s_diff < s_same <= 1.0 + 1e-6
    assert s_same > s_diff + 0.3

    # normalized: |v|_1 == 1
    assert abs(float(jnp.sum(jnp.abs(va1))) - 1.0) < 1e-5


def test_score_database_batch(rng):
    protos = [_random_desc(rng, 40) for _ in range(3)]
    docs = [_perturb(rng, p, 8) for p in protos for _ in range(3)]
    vocab = bow.train(docs, k=5, levels=2, seed=3)
    db = jnp.stack([bow.transform(vocab, jnp.asarray(_perturb(rng, p, 5)),
                                  jnp.ones(40, bool), 2) for p in protos])
    q = bow.transform(vocab, jnp.asarray(_perturb(rng, protos[1], 5)),
                      jnp.ones(40, bool), 2)
    valid = jnp.array([True, True, True])
    s = np.asarray(bow.score_l1_database(q, db, valid))
    assert s.argmax() == 1
    s_masked = np.asarray(bow.score_l1_database(
        q, db, jnp.array([True, False, True])))
    assert s_masked[1] == -1.0


def test_orbvoc_text_roundtrip(tmp_path, rng):
    """Write a tiny ORBvoc-format file; loader rebuilds a working tree."""
    k, L = 2, 2
    lines = [f"{k} {L} 0 0"]
    # hierarchically consistent toy tree: branch A ~ all-zero bits,
    # branch B ~ all-one bits, leaves a few flips off their inner node
    zeros = np.zeros(orb.DESC_WORDS, np.uint32)
    ones = np.full(orb.DESC_WORDS, 0xFFFFFFFF, np.uint32)
    def flip(d, n):
        out = d.copy()
        out[0] ^= np.uint32((1 << n) - 1)
        return out
    descs = np.stack([zeros, zeros, ones,               # root, innerA, innerB
                      flip(zeros, 0), flip(zeros, 6),   # leaves under A
                      flip(ones, 0), flip(ones, 6)])    # leaves under B
    parents = [0, 0, 1, 1, 2, 2]
    leaves = [False, False, True, True, True, True]
    for i in range(6):
        b = np.frombuffer(descs[i + 1].tobytes(), np.uint8)
        lines.append(f"{parents[i]} {int(leaves[i])} "
                     + " ".join(str(x) for x in b) + " 0.5")
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    vocab = bow.load_orbvoc_text(str(p))
    assert vocab.n_words == 4
    assert vocab.children.shape[1] == 2
    # a leaf's own descriptor lands on that leaf's word
    leaf_desc = descs[3:7]
    w = np.asarray(bow.words_of(vocab, jnp.asarray(leaf_desc),
                                jnp.ones(4, bool), L))
    assert len(set(w.tolist())) == 4


def test_deep_vocab_discriminates_at_large_db(rng):
    """Capacity check for the deepened tree (k=10 L=4, ~10k words): with a
    500-document database, a noisy revisit of document j must be the top
    match with a clear score margin over every distractor — the selectivity
    the 1000-word warm-up tree cannot guarantee at this scale
    (the reference ships a k=10 L=6 ORBvoc,
    TemplatedVocabulary.h:408-411)."""
    docs = [_random_desc(rng, 80) for _ in range(120)]
    vocab = bow.train(docs, k=10, levels=4, seed=3)
    L = 4

    D = 500
    db_docs = [_random_desc(rng, 80) for _ in range(D)]
    db = jnp.stack([bow.transform(vocab, jnp.asarray(d),
                                  jnp.ones(len(d), bool), L)
                    for d in db_docs])
    ok = jnp.ones((D,), bool)

    hits = 0
    margins = []
    for j in (7, 123, 321, 444):
        q = _perturb(rng, db_docs[j], bits=18)     # ~7% descriptor noise
        v = bow.transform(vocab, jnp.asarray(q), jnp.ones(len(q), bool), L)
        scores = np.asarray(bow.score_l1_database(v, db, ok))
        top = int(scores.argmax())
        hits += int(top == j)
        others = np.delete(scores, j)
        margins.append(float(scores[j] - others.max()))
    assert hits == 4, (hits, margins)
    assert min(margins) > 0.01, margins

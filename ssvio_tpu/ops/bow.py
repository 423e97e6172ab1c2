"""Bag-of-binary-words vocabulary — the array-form DBoW2 equivalent.

Capability parity with the reference's vendored DBoW2
`TemplatedVocabulary<FORB>` (reference thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h): hierarchical k-means ("k-majority" for binary
descriptors) vocabulary tree with branching k and depth L (:408-411),
`transform(descriptors) -> BowVector` with TF-IDF weighting (:1066-1122,
descent loop :1218-…), L1 similarity `score` (:1199-1203 with
ScoringObject.h:28), and the ORB-SLAM text vocabulary format loader
(`loadFromTextFile`, :1338). Descriptor distance is 256-bit popcount
Hamming (reference thirdparty/DBoW2/DBoW2/FORB.cpp:81-101).

Array-form redesign (not a port):
- The tree lives in dense arrays: node descriptors `[n_nodes, 8] uint32`,
  a children table `[n_nodes, k] int32`, leaf word ids `[n_nodes] int32`.
  `transform` is a FIXED-DEPTH vectorized descent — L rounds of
  (gather k child descriptors, XOR+popcount, argmin) over the whole
  descriptor batch at once; variable-depth leaves are handled by letting
  finished descriptors idle at their leaf. No pointer chasing, one jit.
- BowVectors are DENSE `[n_words] float32` (L1-normalized TF-IDF).
  DBoW2's sparse word->weight maps exist to save CPU cache; a dense
  vector makes database scoring ONE batched pass (`score_l1_database`)
  instead of a per-pair sparse merge.
- Training is host-side numpy (offline path, mirrors DBoW2's `create`):
  k-means++ seeded k-majority clustering, recursing to depth L, IDF
  weights from the training documents.

No external vocabulary file is required: the engine trains its own
vocabulary from the keyframes seen during the loop-closing warm-up window
(the reference instead ships ORB-SLAM's pre-trained ORBvoc.txt — a missing
large blob in the reference checkout, .MISSING_LARGE_BLOBS:3 — and its
database is equally gated on >=50 keyframes before first use,
reference src/ssvio/loopclosing.cpp:48).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ssvio_tpu.ops.orb import DESC_WORDS, _popcount32


class Vocabulary(NamedTuple):
    """Dense vocabulary tree. Leaves carry word ids; inner nodes children."""
    node_desc: jnp.ndarray    # [n_nodes, 8] uint32 cluster centers
    children: jnp.ndarray     # [n_nodes, k] int32 (-1 = missing child)
    word_id: jnp.ndarray      # [n_nodes] int32 (-1 = inner node)
    word_weight: jnp.ndarray  # [n_words] float32 IDF weights

    @property
    def n_words(self) -> int:
        return self.word_weight.shape[0]

    @property
    def k(self) -> int:
        return self.children.shape[1]


# ----------------------------------------------------------------------
# training (host, numpy)
# ----------------------------------------------------------------------

def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits (LSB-first per word, matching
    ops/orb.py packing)."""
    bits = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    return bits.reshape(desc.shape[0], -1).astype(np.uint8)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, 256] {0,1} -> [N, 8] uint32."""
    b = bits.reshape(bits.shape[0], DESC_WORDS, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)


def _hamming_np(bits: np.ndarray, centers_bits: np.ndarray) -> np.ndarray:
    """[N, 256] x [K, 256] -> [N, K] int32 Hamming distances (as matmul)."""
    b = bits.astype(np.float32)
    c = centers_bits.astype(np.float32)
    # d = sum b*(1-c) + (1-b)*c = sum(b) + sum(c) - 2 b.c
    return (b.sum(1, keepdims=True) + c.sum(1)[None, :]
            - 2.0 * (b @ c.T)).astype(np.int32)


def _kmajority(bits: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8):
    """Binary k-means: k-means++ init, majority-vote centers.
    Returns (centers_bits [k', 256], assign [N]); k' <= k."""
    n = bits.shape[0]
    k = min(k, n)
    # k-means++ seeding on Hamming distance
    first = rng.integers(n)
    centers = [bits[first]]
    d_min = _hamming_np(bits, np.array(centers))[:, 0].astype(np.float64)
    for _ in range(1, k):
        p = d_min ** 2
        s = p.sum()
        idx = rng.integers(n) if s <= 0 else rng.choice(n, p=p / s)
        centers.append(bits[idx])
        d_new = _hamming_np(bits, bits[idx][None])[:, 0]
        d_min = np.minimum(d_min, d_new)
    centers = np.array(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(bits, centers)
        assign = d.argmin(1)
        for c in range(len(centers)):
            m = assign == c
            if m.any():
                centers[c] = (bits[m].mean(0) > 0.5).astype(np.uint8)
            else:  # dead cluster: reseed at the farthest point
                far = d.min(1).argmax()
                centers[c] = bits[far]
    d = _hamming_np(bits, centers)
    return centers, d.argmin(1)


def train(documents: Sequence[np.ndarray], k: int = 10, levels: int = 3,
          seed: int = 7, max_train_descriptors: int = 120_000) -> Vocabulary:
    """Build a vocabulary from per-image descriptor sets.

    documents: list of [Ni, 8] uint32 arrays (one per training image).
    k, levels: branching factor and depth (DBoW2 m_k / m_L; the reference
      vocabulary is k=10 L=6 — trained on our smaller corpora we default
      to k=10 L=3 = up to 1000 words).
    """
    rng = np.random.default_rng(seed)
    all_desc = np.concatenate([d for d in documents if len(d)], axis=0)
    if len(all_desc) > max_train_descriptors:
        sel = rng.choice(len(all_desc), max_train_descriptors, replace=False)
        all_desc = all_desc[sel]
    bits = _unpack_bits(all_desc)

    node_desc: List[np.ndarray] = [np.zeros(DESC_WORDS, np.uint32)]  # root
    children: List[List[int]] = [[]]
    word_of_node: List[int] = [-1]
    n_words = 0

    def build(subset: np.ndarray, node: int, level: int):
        nonlocal n_words
        if level == levels or len(subset) <= 1:
            word_of_node[node] = n_words
            n_words += 1
            return
        centers, assign = _kmajority(subset, k, rng)
        for c in range(len(centers)):
            child = len(node_desc)
            node_desc.append(_pack_bits(centers[c][None])[0])
            children.append([])
            word_of_node.append(-1)
            children[node].append(child)
            sub = subset[assign == c]
            build(sub if len(sub) else centers[c][None], child, level + 1)

    build(bits, 0, 0)

    n_nodes = len(node_desc)
    child_tab = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_tab[i, :len(ch)] = ch
    word_id = np.array(word_of_node, np.int32)

    # IDF from training documents: idf(w) = log(N_docs / n_docs(w))
    # (DBoW2 TemplatedVocabulary::setNodeWeights, TemplatedVocabulary.h)
    vocab = Vocabulary(jnp.asarray(np.array(node_desc)),
                       jnp.asarray(child_tab), jnp.asarray(word_id),
                       jnp.ones((n_words,), jnp.float32))
    n_docs = max(1, len(documents))
    seen = np.zeros(n_words, np.int64)
    for d in documents:
        if not len(d):
            continue
        w = np.asarray(words_of(vocab, jnp.asarray(d),
                                jnp.ones(len(d), bool), levels))
        seen[np.unique(w[w >= 0])] += 1
    idf = np.log(n_docs / np.maximum(seen, 1).astype(np.float64))
    # words never seen in training keep weight log(n_docs) (max rarity)
    return vocab._replace(word_weight=jnp.asarray(idf.astype(np.float32)))


# ----------------------------------------------------------------------
# transform + scoring (device, jittable)
# ----------------------------------------------------------------------

def _hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(_popcount32(jnp.bitwise_xor(a, b)), axis=-1)


@functools.partial(jax.jit, static_argnames=("levels",))
def words_of(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray,
             levels: int) -> jnp.ndarray:
    """Tree descent: [N, 8] uint32 -> word id per descriptor [N] int32
    (-1 for invalid). Fixed-depth loop; descriptors that reach a leaf
    early stay there (variable-depth trees from loadFromTextFile)."""
    n = desc.shape[0]
    cur = jnp.zeros((n,), jnp.int32)                      # root
    for _ in range(levels):
        kids = vocab.children[cur]                        # [N, k]
        kd = vocab.node_desc[jnp.maximum(kids, 0)]        # [N, k, 8]
        d = _hamming(desc[:, None, :], kd)                # [N, k]
        d = jnp.where(kids >= 0, d, 1 << 20)
        best = jnp.take_along_axis(
            kids, jnp.argmin(d, axis=1)[:, None], axis=1)[:, 0]
        at_leaf = vocab.children[cur, 0] < 0
        cur = jnp.where(at_leaf, cur, best)
    return jnp.where(valid, vocab.word_id[cur], -1)


@functools.partial(jax.jit, static_argnames=("levels",))
def transform(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray,
              levels: int) -> jnp.ndarray:
    """[N, 8] descriptors -> dense L1-normalized TF-IDF BowVector [n_words].

    Mirrors DBoW2 transform with TF_IDF weighting + L1 normalization
    (TemplatedVocabulary.h:1066-1122)."""
    w = words_of(vocab, desc, valid, levels)
    nw = vocab.word_weight.shape[0]
    tf = jnp.zeros((nw,), jnp.float32).at[jnp.maximum(w, 0)].add(
        jnp.where(w >= 0, 1.0, 0.0))
    v = tf * vocab.word_weight
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-12)


@jax.jit
def score_l1(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score: 1 - 0.5*|v1 - v2|_1 for L1-normalized vectors
    (reference thirdparty/DBoW2/DBoW2/ScoringObject.h:28)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)


@jax.jit
def score_l1_database(v: jnp.ndarray, db: jnp.ndarray,
                      db_valid: jnp.ndarray) -> jnp.ndarray:
    """Score one BowVector against the whole database in one pass.
    v [W], db [D, W], db_valid [D] -> scores [D] (-1 for invalid rows).
    (The reference's per-KF loop over the DBoW2 database,
    src/ssvio/loopclosing.cpp:77-91, as a single batched op.)"""
    s = 1.0 - 0.5 * jnp.sum(jnp.abs(db - v[None, :]), axis=-1)
    return jnp.where(db_valid, s, -1.0)


# ----------------------------------------------------------------------
# ORB-SLAM text-format loader (format parity with DBoW2 loadFromTextFile,
# TemplatedVocabulary.h:1338)
# ----------------------------------------------------------------------

def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse an ORBvoc.txt-style vocabulary.

    Line 1: `k L scoring_type weighting_type`; then one line per non-root
    node: `parent_id is_leaf b0 ... b31 weight` in tree order.
    NOTE: descriptors loaded this way use ORB-SLAM's BRIEF pattern — only
    meaningful if the engine's descriptors use the same pattern; provided
    for file-format parity.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents: List[int] = [-1]
        is_leaf: List[bool] = [False]
        descs: List[np.ndarray] = [np.zeros(32, np.uint8)]
        weights: List[float] = [0.0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(bool(int(parts[1])))
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))

    n = len(parents)
    child_tab = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i in range(1, n):
        p = parents[i]
        child_tab[p, counts[p]] = i
        counts[p] += 1
    word_id = np.full(n, -1, np.int32)
    wword: List[float] = []
    for i in range(n):
        if is_leaf[i]:
            word_id[i] = len(wword)
            wword.append(weights[i])
    packed = np.frombuffer(np.array(descs, np.uint8).tobytes(),
                           np.uint32).reshape(n, DESC_WORDS)
    return Vocabulary(jnp.asarray(packed), jnp.asarray(child_tab),
                      jnp.asarray(word_id),
                      jnp.asarray(np.array(wword, np.float32)))


def tree_depth(vocab: Vocabulary) -> int:
    """Max root->leaf depth of a (possibly variable-depth) tree — the
    descent-round count `transform` needs for a loaded vocabulary (the
    self-trained path knows its depth by construction)."""
    children = np.asarray(vocab.children)
    depth = 0
    frontier = np.array([0], np.int32)
    while frontier.size:
        kids = children[frontier].reshape(-1)
        frontier = kids[kids >= 0]
        if frontier.size:
            depth += 1
        if depth > 64:
            raise ValueError("vocabulary tree deeper than 64 (cycle?)")
    return depth

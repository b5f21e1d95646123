"""Binary visual vocabulary + keyframe database (place recognition).

Replaces DBoW2 (Thirdparty/DBoW2: TemplatedVocabulary k=10, L=5 tree +
inverted file KeyFrameDatabase.cc).  Array-first redesign:

* The hierarchical tree exists to make word lookup O(k*L) on a CPU; on
  an accelerator a FLAT vocabulary of W words is a single [N, W]
  popcount matrix with an argmin — one fused pass, no pointer chasing.
  (SURVEY §7
  "hard parts" already recommends exactly this.)
* The inverted file exists to avoid scoring all keyframes; we instead
  keep the [K, W] TF-IDF matrix resident and score ALL keyframes against
  a query with one matvec — K <= a few thousand keyframes keeps this
  small, and it is exact rather than candidate-pruned.
* Vocabulary centroids default to seeded random binary codes (which give
  a valid LSH-style quantizer); train_vocabulary() runs batched binary
  k-means (majority-bit medians) for dataset-adapted vocabularies, the
  analog of DBoW2's offline k-medians training, and carries per-word IDF
  weights measured on the training corpus (TemplatedVocabulary's TF_IDF
  weighting, TemplatedVocabulary.h:1066-1218).

Scoring is DBoW2's L1 score on L1-normalized TF-IDF vectors:
s(v, w) = 1 - 0.5*|v/|v| - w/|w||_1 (ScoringObject.cpp, used via
ORBVocabulary at System.cc:64).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hamming import hamming_pairwise
from ..ops.orb import DESC_WORDS, N_BITS


class Vocabulary(NamedTuple):
    """Flat binary vocabulary with TF-IDF word weights.

    words: [W, DESC_WORDS] u32 N_BITS-bit centroids
    idf:   [W] f32 per-word inverse document frequency (all-ones for an
           untrained/random vocabulary -> plain TF)
    """

    words: jnp.ndarray
    idf: jnp.ndarray

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def _words_idf(vocab):
    """Accept a Vocabulary or a bare [W,W32] word array (legacy callers)."""
    if isinstance(vocab, Vocabulary):
        return vocab.words, vocab.idf
    return vocab, None


def make_vocabulary(n_words: int = 4096, seed: int = 42) -> Vocabulary:
    """Random binary vocabulary (uniform IDF)."""
    rng = np.random.RandomState(seed)
    words = jnp.asarray(
        rng.randint(0, 2**32, size=(n_words, DESC_WORDS), dtype=np.uint64).astype(np.uint32)
    )
    return Vocabulary(words, jnp.ones((n_words,), jnp.float32))


def save_vocabulary(path: str, vocab: Vocabulary):
    np.savez(path, words=np.asarray(vocab.words), idf=np.asarray(vocab.idf))


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    return Vocabulary(jnp.asarray(z["words"]), jnp.asarray(z["idf"]))


@jax.jit
def assign_words(vocab, desc: jnp.ndarray, valid: jnp.ndarray):
    """Nearest vocabulary word per descriptor: [N] i32 (argmin Hamming)."""
    words, _ = _words_idf(vocab)
    d = hamming_pairwise(desc, words)  # [N, W]
    w = jnp.argmin(d, axis=1).astype(jnp.int32)
    return jnp.where(valid, w, -1)


@jax.jit
def bow_vector(vocab, desc: jnp.ndarray, valid: jnp.ndarray):
    """L1-normalized TF-IDF BoW vector [W] f32 (plain TF when the
    vocabulary carries no IDF weights)."""
    words, idf = _words_idf(vocab)
    W = words.shape[0]
    w = assign_words(words, desc, valid)
    counts = jnp.zeros((W,), jnp.float32).at[jnp.clip(w, 0)].add(
        valid.astype(jnp.float32)
    )
    if idf is not None:
        counts = counts * idf
    return counts / jnp.maximum(jnp.sum(counts), 1e-9)


@jax.jit
def l1_scores(bows: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity of query q [W] against rows of bows [K, W]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(bows - q[None, :]), axis=1)


def train_vocabulary(descs: np.ndarray, n_words: int = 4096, iters: int = 8,
                     seed: int = 0,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Batched binary k-means (majority-bit medians) over [M, 8] u32
    descriptors — the flat analog of DBoW2's hierarchical k-medians
    training (TemplatedVocabulary::create) — plus corpus IDF weights
    when per-descriptor document (image) ids are supplied
    (TemplatedVocabulary::setNodeWeights semantics: idf = log(N/Ni))."""
    rng = np.random.RandomState(seed)
    M = descs.shape[0]
    centroids = jnp.asarray(descs[rng.choice(M, n_words, replace=M < n_words)])
    d = jnp.asarray(descs)

    bits = jnp.unpackbits(
        jnp.asarray(descs).view(jnp.uint8), axis=-1, bitorder="little"
    ).reshape(M, N_BITS)

    # chunk the assignment step: the full [M, W] distance matrix at
    # W = 32k words and M ~ 1e5 descriptors is ~17 GB — beyond HBM
    chunk = max(1, min(M, (1 << 28) // max(n_words, 1)))

    @jax.jit
    def _assign_chunk(dc, cent):
        return jnp.argmin(hamming_pairwise(dc, cent), axis=1)

    def assign_all(cent):
        outs = []
        for s in range(0, M, chunk):
            outs.append(_assign_chunk(d[s:s + chunk], cent))
        return jnp.concatenate(outs)

    assign = None
    for _ in range(iters):
        assign = assign_all(centroids)
        # majority bit per centroid
        ones = jnp.zeros((n_words, N_BITS), jnp.float32).at[assign].add(
            bits.astype(jnp.float32)
        )
        count = jnp.zeros((n_words,), jnp.float32).at[assign].add(1.0)
        maj = (ones > 0.5 * jnp.maximum(count, 1.0)[:, None]).astype(jnp.uint8)
        packed = jnp.packbits(maj, axis=-1, bitorder="little").view(jnp.uint32)
        # keep old centroid for empty clusters
        centroids = jnp.where((count > 0)[:, None], packed, centroids)

    idf = np.ones((n_words,), np.float32)
    if doc_ids is not None and assign is not None:
        # re-assign against the final centroids, then document frequency
        final = np.asarray(assign_all(centroids))
        doc_ids = np.asarray(doc_ids)
        n_docs = int(doc_ids.max()) + 1
        df = np.zeros((n_words,), np.int64)
        pairs = np.unique(np.stack([final, doc_ids], 1), axis=0)
        np.add.at(df, pairs[:, 0], 1)
        # DBoW2: words seen in every (or no) document carry ~no information
        idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
        idf = np.where(df == 0, 0.0, idf)
    return Vocabulary(centroids, jnp.asarray(idf))


class KeyFrameDatabase(NamedTuple):
    """Dense BoW score table over keyframe slots ([K, W] f32).

    Functional analog of KeyFrameDatabase.cc's inverted file: add/erase
    are row writes; queries are one matvec + masking.
    """

    bows: jnp.ndarray  # [K, W]

    @staticmethod
    def create(max_kf: int, n_words: int) -> "KeyFrameDatabase":
        return KeyFrameDatabase(jnp.zeros((max_kf, n_words), jnp.float32))

    def add(self, slot, bow: jnp.ndarray) -> "KeyFrameDatabase":
        return KeyFrameDatabase(self.bows.at[slot].set(bow))

    def erase(self, slot) -> "KeyFrameDatabase":
        return KeyFrameDatabase(self.bows.at[slot].set(0.0))


@partial(jax.jit, static_argnums=(4,))
def detect_relocalization_candidates(db: KeyFrameDatabase, q: jnp.ndarray,
                                     kf_valid: jnp.ndarray,
                                     covis: jnp.ndarray | None = None,
                                     max_candidates: int = 8):
    """Relocalization candidates (DetectRelocalizationCandidates,
    KeyFrameDatabase.cc:228): score all valid KFs, accumulate over each
    candidate's covisibility group, keep >= 0.75 * best accumulated score.

    covis: [K,K] covisibility weights (or None to skip accumulation).
    Returns (slots [max_candidates], ok [max_candidates]).
    """
    s = l1_scores(db.bows, q)
    s = jnp.where(kf_valid, s, -1.0)
    if covis is not None:
        # accumulate scores over top-covisible groups like the reference
        nb = covis > 0
        acc = s + jnp.sum(jnp.where(nb, s[None, :], 0.0), axis=1)
    else:
        acc = s
    best = jnp.max(acc)
    ok_mask = kf_valid & (acc >= 0.75 * best) & (s > 0)
    score_sel = jnp.where(ok_mask, acc, -1.0)
    top, slots = jax.lax.top_k(score_sel, max_candidates)
    return slots, top > 0


@partial(jax.jit, static_argnums=(5,))
def detect_loop_candidates(db: KeyFrameDatabase, q: jnp.ndarray,
                           kf_valid: jnp.ndarray, exclude: jnp.ndarray,
                           min_score: jnp.ndarray, max_candidates: int = 8):
    """Loop candidates (DetectLoopCandidates, KeyFrameDatabase.cc:95):
    like relocalization but excluding the query's covisible neighborhood
    and thresholding at the neighborhood's own min BoW score.

    exclude: [K] bool — the current KF + its covisible neighbors.
    """
    s = l1_scores(db.bows, q)
    s = jnp.where(kf_valid & ~exclude, s, -1.0)
    ok = s >= jnp.maximum(min_score, 0.0)
    score_sel = jnp.where(ok, s, -1.0)
    top, slots = jax.lax.top_k(score_sel, max_candidates)
    return slots, top > 0

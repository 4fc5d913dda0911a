"""Binary bag-of-words place recognition.

Batched replacement for the reference's FAB-MAP 2.0 pipeline
(reference: src/VisualPlaceRecognition/visualplacerecognition.cpp:60-129 —
detector + BoW descriptor against a pretrained vocabulary + Chow-Liu-tree
inference; vendored openFABMAP). FAB-MAP's generative model needs an
offline-trained vocabulary + co-occurrence tree; this design uses
a fixed random binary vocabulary with tf-idf-weighted cosine scoring — the
standard DBoW-class approach — whose whole scoring pass is two matmuls
(descriptor→word assignment, signature×signature similarity), trivially
shardable across devices for large maps.

Contract preserved from the reference: per-keyframe probability-ranked
candidates, tail-frame skip, probability normalization
(visualplacerecognition.cpp:99-118), bounded candidate queue
(loopClosureLocal.cpp:111-125).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DESC_BITS = 256


def make_vocab(vocab_size: int, seed: int = 17) -> jnp.ndarray:
    """(V, 256) ±1 random binary word prototypes (fixed seed → deterministic
    across runs; replaces the downloaded FAB-MAP vocabulary, build.sh:21-33)."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.choice(np.array([-1, 1], np.int8), size=(vocab_size, DESC_BITS)))


def signature(vocab: jnp.ndarray, desc: jnp.ndarray, valid: jnp.ndarray
              ) -> jnp.ndarray:
    """tf signature (V,) of one frame: histogram of nearest-word assignments,
    L2-normalized. desc: (N, 256) ±1 int8; valid: (N,)."""
    V = vocab.shape[0]
    dots = jax.lax.dot_general(
        desc, vocab, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)                  # (N, V)
    word = jnp.argmax(dots, axis=1)                        # nearest word
    hist = jnp.zeros((V,), jnp.float32).at[word].add(valid.astype(jnp.float32))
    return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-9)


def score_against(signatures: jnp.ndarray, sig: jnp.ndarray,
                  sig_valid: jnp.ndarray, use_idf: bool = True
                  ) -> jnp.ndarray:
    """tf-idf cosine similarity of ``sig`` (V,) against all stored keyframe
    signatures (K, V) → (K,); invalid rows get -inf.

    idf is computed on the fly from the stored corpus (the valid keyframe
    signatures): ``idf_v = log((1+K)/(1+df_v))`` with df the number of
    keyframes whose tf for word v is nonzero — words seen in every keyframe
    (repetitive texture) contribute ~nothing, discriminative words dominate.
    ``use_idf=False`` gives the plain tf cosine (round-2 behavior)."""
    if use_idf:
        n_docs = jnp.sum(sig_valid.astype(jnp.float32))
        df = jnp.sum(((signatures > 0.0) & sig_valid[:, None]).astype(jnp.float32),
                     axis=0)                                   # (V,)
        idf = jnp.log((1.0 + n_docs) / (1.0 + df))
        ws = signatures * idf[None, :]                         # (K, V)
        wq = sig * idf
        ws = ws / jnp.maximum(jnp.linalg.norm(ws, axis=1, keepdims=True), 1e-9)
        wq = wq / jnp.maximum(jnp.linalg.norm(wq), 1e-9)
        s = ws @ wq
    else:
        s = signatures @ sig
    return jnp.where(sig_valid, s, -jnp.inf)


class LCQueue(NamedTuple):
    """Fixed-capacity priority buffer of loop-closure candidates — the
    array analog of the reference's ``priority_queue<LCMatch>``
    (loopClosure.h:119-121, trimmed loopClosureLocal.cpp:111-125)."""

    kf_a: jnp.ndarray   # (Q,) int32 — current keyframe
    kf_b: jnp.ndarray   # (Q,) int32 — candidate past keyframe
    prob: jnp.ndarray   # (Q,) float32 — normalized score (−inf = empty)


def init_queue(capacity: int) -> LCQueue:
    return LCQueue(
        kf_a=jnp.full((capacity,), -1, jnp.int32),
        kf_b=jnp.full((capacity,), -1, jnp.int32),
        prob=jnp.full((capacity,), -jnp.inf, jnp.float32),
    )


def push_candidates(q: LCQueue, kf_a, scores: jnp.ndarray, kf_seq, n_kf,
                    tail_skip: int, min_score: float,
                    top_k: int = 4) -> LCQueue:
    """Gate, rank, and merge the best new candidates into the queue, keeping
    the overall top-capacity by score.

    ``kf_seq``: (K,) sequential keyframe number per ring slot (wrap-safe
    recency: the reference skips the ``tail_skip`` most recent *frames*,
    visualplacerecognition.cpp:99-118 — slot indices alone are wrong once
    the ring wraps). ``min_score`` gates on the raw tf-idf cosine (0..1):
    FAB-MAP emits true normalized posteriors, our cosine corpus scores are
    flat across many keyframes, so sum-normalizing (round-2 behavior) made
    any threshold unreachable — the absolute cosine is the DBoW-class
    acceptance this scoring actually supports."""
    recent = (kf_seq > n_kf - 1 - tail_skip) | (kf_seq < 0)
    s = jnp.where(recent, -jnp.inf, scores)
    s = jnp.where(s >= min_score, s, -jnp.inf)
    top_p, top_i = jax.lax.top_k(s, top_k)

    cand_a = jnp.full((top_k,), kf_a, jnp.int32)
    all_a = jnp.concatenate([q.kf_a, cand_a])
    all_b = jnp.concatenate([q.kf_b, top_i.astype(jnp.int32)])
    all_p = jnp.concatenate([q.prob, top_p])
    keep_p, keep_i = jax.lax.top_k(all_p, q.prob.shape[0])
    return LCQueue(all_a[keep_i], all_b[keep_i], keep_p)


def pop_best(q: LCQueue):
    """Best candidate + queue with that slot cleared (PQ pop,
    loopClosure.h:79-92). Returns (kf_a, kf_b, prob, queue')."""
    i = jnp.argmax(q.prob)
    a, b, p = q.kf_a[i], q.kf_b[i], q.prob[i]
    q2 = LCQueue(
        q.kf_a.at[i].set(-1), q.kf_b.at[i].set(-1),
        q.prob.at[i].set(-jnp.inf))
    return a, b, p, q2

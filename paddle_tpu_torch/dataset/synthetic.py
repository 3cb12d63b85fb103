"""The port's copy of ``paddle_tpu/dataset/synthetic.py``.

Deterministic synthetic data generators with learnable structure.

Used as offline fallbacks: samples are class-prototype + noise so models
demonstrably converge, matching each real dataset's schema. The task
structure (prototypes / weights / tag tables) is derived from ``task_seed``
and the sampling stream from ``seed`` — train/test splits share the task
by sharing task_seed while differing in seed.
"""

import numpy as np


def classification(num_samples, feature_dim, num_classes, seed=0, noise=0.3,
                   task_seed=1234):
    """Gaussian class prototypes + noise."""
    protos = np.random.RandomState(task_seed).randn(
        num_classes, feature_dim).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for i in range(num_samples):
            y = int(r.randint(num_classes))
            x = protos[y] + noise * r.randn(feature_dim).astype(np.float32)
            yield x.astype(np.float32), y
    return reader


def regression(num_samples, feature_dim, seed=0, noise=0.1, task_seed=1234):
    rng = np.random.RandomState(task_seed)
    w = rng.randn(feature_dim).astype(np.float32)
    b = float(rng.randn())

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(num_samples):
            x = r.randn(feature_dim).astype(np.float32)
            y = float(x @ w + b + noise * r.randn())
            yield x, np.array([y], np.float32)
    return reader


def sequence_classification(num_samples, vocab_size, num_classes, seed=0,
                            min_len=5, max_len=30, task_seed=1234):
    """Integer sequences whose class is signalled by token distribution —
    an IMDB-like schema (list[int], int)."""
    rng = np.random.RandomState(task_seed)
    # each class prefers a distinct slice of the vocabulary
    prefs = [rng.permutation(vocab_size)[: vocab_size // 2]
             for _ in range(num_classes)]

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(num_samples):
            y = int(r.randint(num_classes))
            n = int(r.randint(min_len, max_len + 1))
            mix = r.rand(n) < 0.75
            toks = np.where(mix, r.choice(prefs[y], n),
                            r.randint(0, vocab_size, n))
            yield toks.astype(np.int64).tolist(), y
    return reader


def sequence_tagging(num_samples, vocab_size, num_tags, seed=0,
                     min_len=5, max_len=20, task_seed=1234):
    """Token-level tags correlated with token ids (CoNLL-like schema:
    (list[int] words, list[int] tags))."""
    tag_of = np.random.RandomState(task_seed).randint(0, num_tags, vocab_size)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(num_samples):
            n = int(r.randint(min_len, max_len + 1))
            toks = r.randint(0, vocab_size, n)
            tags = tag_of[toks].copy()
            flip = r.rand(n) < 0.1
            tags[flip] = r.randint(0, num_tags, int(flip.sum()))
            yield toks.astype(np.int64).tolist(), tags.astype(np.int64).tolist()
    return reader

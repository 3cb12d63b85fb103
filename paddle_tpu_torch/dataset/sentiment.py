"""The port's copy of ``paddle_tpu/dataset/sentiment.py``.

NLTK movie_reviews sentiment (reference:
python/paddle/v2/dataset/sentiment.py — 2000 polar reviews, pos/neg
interleaved, word ids by corpus frequency; first 1600 train, rest test).

Real path reads the extracted ``movie_reviews`` corpus directory (neg/ and
pos/ subdirs of .txt files) from the dataset cache; offline fallback keeps
the (list[int], 0/1) schema.
"""

import collections
import os
import re

from paddle_tpu_torch.dataset import common, synthetic

CORPUS_DIR = "movie_reviews"
NUM_TRAINING_INSTANCES = 1600
VOCAB_SIZE = 3000

_cache = None


def _corpus_path():
    p = os.path.join(common.DATA_HOME, "sentiment", CORPUS_DIR)
    return p if os.path.isdir(p) else None


def _tokenize(text):
    return re.findall(r"[a-z0-9']+|[.,!?;]", text.lower())


def _load():
    """(word_dict, samples) — samples interleave neg/pos for balanced
    minibatches (sentiment.py sort_files)."""
    global _cache
    if _cache is not None:
        return _cache
    root = _corpus_path()
    docs = {"neg": [], "pos": []}
    for cat in ("neg", "pos"):
        d = os.path.join(root, cat)
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn), errors="ignore") as f:
                docs[cat].append(_tokenize(f.read()))
    freq = collections.defaultdict(int)
    for cat in docs:
        for doc in docs[cat]:
            for w in doc:
                freq[w] += 1
    ranked = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    word_dict = {w: i for i, (w, _) in enumerate(ranked)}
    samples = []
    for neg, pos in zip(docs["neg"], docs["pos"]):
        samples.append(([word_dict[w] for w in neg], 0))
        samples.append(([word_dict[w] for w in pos], 1))
    _cache = (word_dict, samples)
    return _cache


def get_word_dict():
    if _corpus_path():
        word_dict, _ = _load()
        return sorted(word_dict.items(), key=lambda kv: kv[1])
    return [(f"w{i}", i) for i in range(VOCAB_SIZE)]


def _make_reader(lo, hi):
    def reader():
        _, samples = _load()
        for sample in samples[lo:hi]:
            yield sample
    return reader


def train():
    if _corpus_path():
        return common.real_data(_make_reader(0, NUM_TRAINING_INSTANCES))
    return common.synthetic_fallback(
        "sentiment", "train", synthetic.sequence_classification(
            1600, VOCAB_SIZE, 2, seed=61, min_len=20, max_len=200))


def test():
    if _corpus_path():
        return common.real_data(_make_reader(NUM_TRAINING_INSTANCES, None))
    return common.synthetic_fallback(
        "sentiment", "test", synthetic.sequence_classification(
            400, VOCAB_SIZE, 2, seed=611, min_len=20, max_len=200))


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'sentiment_train')
    out += common.convert(path, test(), line_count, 'sentiment_test')
    return out

"""The port's copy of ``paddle_tpu/dataset/mq2007.py``.

MQ2007 learning-to-rank (reference: python/paddle/v2/dataset/mq2007.py —
LETOR text format ``rel qid:N 1:v1 ... 46:v46``, grouped by query, emitted
pointwise / pairwise / listwise).

Formats (mq2007.py gen_point/gen_pair/gen_list):
- pointwise: (relevance_score, 46-vector)
- pairwise:  (np.ones(1), better_vector, worse_vector)
- listwise:  (scores_array, vectors_array) per query

Offline fallback: a linear relevance model over synthetic feature vectors so
rank costs train.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset import common

FEATURE_DIM = 46
_FOLD_FILES = {"train": "train.txt", "test": "test.txt", "vali": "vali.txt"}


class QueryList:
    def __init__(self, query_id):
        self.query_id = query_id
        self.relevance_score = []
        self.feature_vector = []

    def append(self, rel, vec):
        self.relevance_score.append(rel)
        self.feature_vector.append(vec)


def _parse_letor(path):
    """Stream QueryList groups from a LETOR file (mq2007.py load_from_text)."""
    current = None
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(parts[0])
            qid = int(parts[1].split(":")[1])
            vec = np.zeros(FEATURE_DIM, np.float32)
            for tok in parts[2:]:
                k, v = tok.split(":")
                k = int(k)
                if 1 <= k <= FEATURE_DIM:
                    vec[k - 1] = float(v)
            if current is None or current.query_id != qid:
                if current is not None:
                    yield current
                current = QueryList(qid)
            current.append(rel, vec)
    if current is not None:
        yield current


def _synthetic_queries(num_queries, seed):
    w = np.random.RandomState(1234).randn(FEATURE_DIM).astype(np.float32)

    def gen():
        r = np.random.RandomState(seed)
        for qid in range(num_queries):
            q = QueryList(qid)
            for _ in range(int(r.randint(4, 16))):
                vec = r.randn(FEATURE_DIM).astype(np.float32)
                score = float(vec @ w) + 0.3 * float(r.randn())
                q.append(int(np.clip(round(score / 2 + 1), 0, 2)), vec)
            yield q
    return gen


def _emit(querylists, fmt):
    for q in querylists:
        scores = np.asarray(q.relevance_score, np.float32)
        vecs = np.asarray(q.feature_vector, np.float32)
        if fmt == "pointwise":
            for s, v in zip(scores, vecs):
                yield float(s), v
        elif fmt == "pairwise":
            n = len(scores)
            for i in range(n):
                for j in range(n):
                    if scores[i] > scores[j]:
                        yield np.ones(1, np.float32), vecs[i], vecs[j]
        elif fmt == "listwise":
            yield scores, vecs
        else:
            raise ValueError(f"unknown format {fmt!r}")


def _reader_creator(split, fmt):
    fold = os.path.join(common.DATA_HOME, "mq2007", "MQ2007", "Fold1",
                        _FOLD_FILES.get(split, split))
    if os.path.exists(fold):
        def reader():
            yield from _emit(_parse_letor(fold), fmt)
        return common.real_data(reader)
    seed = {"train": 91, "test": 911, "vali": 9111}.get(split, 99)
    nq = 256 if split == "train" else 64

    def reader():
        yield from _emit(_synthetic_queries(nq, seed)(), fmt)
    return common.synthetic_fallback("mq2007", split, reader)


def train(format="pairwise"):
    return _reader_creator("train", format)


def test(format="pairwise"):
    return _reader_creator("test", format)

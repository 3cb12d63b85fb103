"""The port's copy of ``paddle_tpu/dataset/imdb.py``.

IMDB sentiment (reference: python/paddle/v2/dataset/imdb.py — tokenized
reviews as word-id sequences + binary label, parsed from aclImdb_v1.tar.gz).

Real path: sequential scan of the cached tarball (the reference deliberately
used tarfile.next() streaming, imdb.py:40); offline fallback: synthetic
sequences with the same (list[int], int) schema, loudly labelled.
"""

import collections
import re
import string
import tarfile

from paddle_tpu_torch.dataset import common, synthetic

ARCHIVE = "aclImdb_v1.tar.gz"
VOCAB_SIZE = 5000

_TRAIN_POS = re.compile(r"aclImdb/train/pos/.*\.txt$")
_TRAIN_NEG = re.compile(r"aclImdb/train/neg/.*\.txt$")
_TEST_POS = re.compile(r"aclImdb/test/pos/.*\.txt$")
_TEST_NEG = re.compile(r"aclImdb/test/neg/.*\.txt$")
_PUNCT = str.maketrans("", "", string.punctuation)


def tokenize(pattern):
    """Stream tokenized docs whose member name matches ``pattern``."""
    path = common.cached_file("imdb", ARCHIVE)
    if not path:
        return
    with tarfile.open(path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if pattern.match(tf.name):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="ignore")
                yield text.rstrip("\n\r").translate(_PUNCT).lower().split()
            tf = tarf.next()


_TRAIN_ANY = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
_dict_cache = {}


def build_dict(pattern=None, cutoff=150):
    """Word -> id by descending frequency, '<unk>' last (imdb.py:57).
    Memoized — the tarball scan is expensive and train()/test() both need
    it; the default pattern covers pos+neg in ONE sequential pass."""
    key = (pattern.pattern if pattern else None, cutoff)
    if key in _dict_cache:
        return _dict_cache[key]
    if common.cached_file("imdb", ARCHIVE):
        freq = collections.defaultdict(int)
        for doc in tokenize(pattern or _TRAIN_ANY):
            for w in doc:
                freq[w] += 1
        kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
    else:
        word_idx = {f"w{i}": i for i in range(VOCAB_SIZE)}
        word_idx["<unk>"] = len(word_idx)
    _dict_cache[key] = word_idx
    return word_idx


# back-compat alias used by models/tests
def word_dict():
    return build_dict()


def _real_reader(pos_pat, neg_pat, word_idx):
    unk = word_idx["<unk>"]

    def reader():
        # alternate pos/neg so minibatches stay balanced (imdb.py:78)
        pos = ((doc, 1) for doc in tokenize(pos_pat))
        neg = ((doc, 0) for doc in tokenize(neg_pat))
        iters, i = [pos, neg], 0
        exhausted = [False, False]
        while not all(exhausted):
            if not exhausted[i % 2]:
                try:
                    doc, lbl = next(iters[i % 2])
                    yield [word_idx.get(w, unk) for w in doc], lbl
                except StopIteration:
                    exhausted[i % 2] = True
            i += 1
    return reader


def train(word_idx=None):
    if common.cached_file("imdb", ARCHIVE):
        wi = word_idx or build_dict()
        return common.real_data(_real_reader(_TRAIN_POS, _TRAIN_NEG, wi))
    n = len(word_idx) if word_idx else VOCAB_SIZE
    return common.synthetic_fallback(
        "imdb", "train", synthetic.sequence_classification(
            4096, n, 2, seed=21, min_len=8, max_len=60))


def test(word_idx=None):
    if common.cached_file("imdb", ARCHIVE):
        wi = word_idx or build_dict()
        return common.real_data(_real_reader(_TEST_POS, _TEST_NEG, wi))
    n = len(word_idx) if word_idx else VOCAB_SIZE
    return common.synthetic_fallback(
        "imdb", "test", synthetic.sequence_classification(
            512, n, 2, seed=211, min_len=8, max_len=60))


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'imdb_train')
    out += common.convert(path, test(), line_count, 'imdb_test')
    return out

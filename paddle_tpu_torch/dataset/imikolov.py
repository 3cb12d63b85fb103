"""The port's copy of ``paddle_tpu/dataset/imikolov.py``.

PTB language-model dataset (reference: python/paddle/v2/dataset/imikolov.py
— n-gram windows or (src, trg) sequences of word ids from the Mikolov
simple-examples PTB text).

Real path: parse ptb.train.txt / ptb.valid.txt out of the cached
simple-examples.tgz; offline fallback: synthetic n-grams, loudly labelled.
"""

import collections
import tarfile

from paddle_tpu_torch.dataset import common, synthetic

ARCHIVE = "simple-examples.tgz"
TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
VALID_FILE = "./simple-examples/data/ptb.valid.txt"
VOCAB_SIZE = 2000


class DataType:
    NGRAM = 1
    SEQ = 2


def _lines(member):
    path = common.cached_file("imikolov", ARCHIVE)
    with tarfile.open(path) as tf:
        for raw in tf.extractfile(member):
            yield raw.decode("utf-8", errors="ignore")


_dict_cache = {}


def build_dict(min_word_freq=50):
    """Word -> id by descending frequency over train+valid, '<s>'/'<e>'
    counted per line, '<unk>' last (imikolov.py:48-73). Memoized — the
    tarball scan is expensive and train()/test() both need it."""
    if min_word_freq in _dict_cache:
        return _dict_cache[min_word_freq]
    if not common.cached_file("imikolov", ARCHIVE):
        d = {f"w{i}": i for i in range(VOCAB_SIZE)}
        d.setdefault("<unk>", len(d))
        d.setdefault("<s>", len(d))
        d.setdefault("<e>", len(d))
        return d
    freq = collections.defaultdict(int)
    for member in (TRAIN_FILE, VALID_FILE):
        for line in _lines(member):
            for w in line.strip().split():
                freq[w] += 1
            freq["<s>"] += 1
            freq["<e>"] += 1
    freq.pop("<unk>", None)
    kept = sorted(((w, c) for w, c in freq.items() if c > min_word_freq),
                  key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    _dict_cache[min_word_freq] = word_idx
    return word_idx


def _real_reader(member, word_idx, n, data_type):
    unk = word_idx["<unk>"]

    def reader():
        for line in _lines(member):
            if data_type == DataType.NGRAM:
                toks = ["<s>"] + line.strip().split() + ["<e>"]
                if len(toks) >= n:
                    ids = [word_idx.get(w, unk) for w in toks]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            else:
                ids = [word_idx.get(w, unk) for w in line.strip().split()]
                src = [word_idx["<s>"]] + ids
                trg = ids + [word_idx["<e>"]]
                if n > 0 and len(src) > n:
                    continue
                yield src, trg
    return reader


def _synthetic(split, num, vocab, n, seed, data_type):
    if data_type == DataType.NGRAM:
        seq = synthetic.sequence_classification(
            num, vocab, 2, seed=seed, min_len=n + 2, max_len=40)

        def reader():
            for toks, _ in seq():
                for i in range(len(toks) - n + 1):
                    yield tuple(toks[i:i + n])
    else:
        # SEQ mode: n is a max src length cutoff (n<=0 = unlimited), so
        # generate sequences that fit under it
        max_len = min(n - 1, 40) if n > 0 else 40
        seq = synthetic.sequence_classification(
            num, vocab, 2, seed=seed, min_len=min(3, max_len),
            max_len=max_len)

        def reader():
            bos, eos = vocab - 2, vocab - 1
            for toks, _ in seq():
                yield [bos] + toks, toks + [eos]
    return common.synthetic_fallback("imikolov", split, reader)


def train(word_idx=None, n=5, data_type=DataType.NGRAM):
    if common.cached_file("imikolov", ARCHIVE):
        wi = word_idx or build_dict()
        return common.real_data(_real_reader(TRAIN_FILE, wi, n, data_type))
    vocab = len(word_idx) if word_idx else VOCAB_SIZE
    return _synthetic("train", 2048, vocab, n, 31, data_type)


def test(word_idx=None, n=5, data_type=DataType.NGRAM):
    if common.cached_file("imikolov", ARCHIVE):
        wi = word_idx or build_dict()
        return common.real_data(_real_reader(VALID_FILE, wi, n, data_type))
    vocab = len(word_idx) if word_idx else VOCAB_SIZE
    return _synthetic("test", 256, vocab, n, 311, data_type)


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'imikolov_train')
    out += common.convert(path, test(), line_count, 'imikolov_test')
    return out

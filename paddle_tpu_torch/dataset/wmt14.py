"""The port's copy of ``paddle_tpu/dataset/wmt14.py``.

WMT14 FR→EN translation (reference: python/paddle/v2/dataset/wmt14.py —
the shrunk wmt14.tgz with src.dict/trg.dict and tab-separated parallel text).

Sample schema (wmt14.py reader_creator): ``(src_ids, trg_ids, trg_ids_next)``
where src has <s>/<e> wrappers, trg starts with <s>, trg_next ends with <e>,
OOV -> <unk> (id 2), pairs longer than 80 tokens dropped. Offline fallback:
a deterministic token-mapping translation task (trg = permuted src vocab) so
seq2seq demonstrably learns.
"""

import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

ARCHIVE = "wmt14.tgz"
START, END, UNK = "<s>", "<e>", "<unk>"
UNK_IDX = 2
_SYN_SRC_VOCAB = _SYN_TRG_VOCAB = 1000

_dict_cache = {}


def _read_dicts(dict_size):
    if dict_size in _dict_cache:
        return _dict_cache[dict_size]
    path = common.cached_file("wmt14", ARCHIVE)
    src_dict, trg_dict = {}, {}
    with tarfile.open(path) as tf:
        for member in tf:
            if member.name.endswith("src.dict"):
                target = src_dict
            elif member.name.endswith("trg.dict"):
                target = trg_dict
            else:
                continue
            for i, line in enumerate(tf.extractfile(member)):
                if i >= dict_size:
                    break
                target[line.decode("utf-8", errors="ignore").strip()] = i
    _dict_cache[dict_size] = (src_dict, trg_dict)
    return src_dict, trg_dict


def _real_reader(file_name, dict_size):
    def reader():
        src_dict, trg_dict = _read_dicts(dict_size)
        path = common.cached_file("wmt14", ARCHIVE)
        with tarfile.open(path) as tf:
            names = [m.name for m in tf if m.name.endswith(file_name)]
            for name in names:
                for line in tf.extractfile(name):
                    parts = line.decode("utf-8",
                                        errors="ignore").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + parts[0].split() + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK_IDX) for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    yield (src_ids, [trg_dict[START]] + trg_ids,
                           trg_ids + [trg_dict[END]])
    return reader


def _synthetic_reader(split, dict_size, num, seed):
    """Permutation-translation: target token = fixed permutation of source
    token — a seq2seq task a model can actually drive to zero loss."""
    vs = min(dict_size, _SYN_SRC_VOCAB)
    perm = np.random.RandomState(1234).permutation(vs)
    s_bos, s_eos = 0, 1
    t_bos, t_eos = 0, 1

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(num):
            n = int(r.randint(4, 20))
            src = r.randint(3, vs, n)
            trg = perm[src] % vs
            trg = np.where(trg < 3, 3, trg)
            yield ([s_bos] + src.tolist() + [s_eos],
                   [t_bos] + trg.tolist(),
                   trg.tolist() + [t_eos])
    return common.synthetic_fallback("wmt14", split, reader)


def train(dict_size=30000):
    if common.cached_file("wmt14", ARCHIVE):
        return common.real_data(_real_reader("train/train", dict_size))
    return _synthetic_reader("train", dict_size, 4096, seed=51)


def test(dict_size=30000):
    if common.cached_file("wmt14", ARCHIVE):
        return common.real_data(_real_reader("test/test", dict_size))
    return _synthetic_reader("test", dict_size, 512, seed=511)


def gen(dict_size=30000):
    if common.cached_file("wmt14", ARCHIVE):
        return common.real_data(_real_reader("gen/gen", dict_size))
    return _synthetic_reader("gen", dict_size, 64, seed=5111)


def get_dict(dict_size=30000, reverse=True):
    """id->word maps when reverse (wmt14.py get_dict)."""
    if common.cached_file("wmt14", ARCHIVE):
        src_dict, trg_dict = _read_dicts(dict_size)
    else:
        vs = min(dict_size, _SYN_SRC_VOCAB)
        src_dict = {f"s{i}": i for i in range(vs)}
        trg_dict = {f"t{i}": i for i in range(vs)}
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict

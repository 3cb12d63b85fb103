"""The port's copy of ``paddle_tpu/dataset/conll05.py``.

CoNLL-2005 semantic role labeling (reference:
python/paddle/v2/dataset/conll05.py — 9-feature SRL samples built from the
public test split of conll05st plus word/verb/label dictionaries).

Sample schema (conll05.py reader_creator): ``(word_idx, ctx_n2, ctx_n1,
ctx_0, ctx_p1, ctx_p2, pred_idx, mark, label_idx)`` — all sequences of
sentence length; the five ctx features broadcast the predicate window and
``mark`` flags the window positions. Real path parses the cached tarball;
offline fallback synthesises tagged sentences with the same 9-slot schema.
"""

import gzip
import itertools
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

ARCHIVE = "conll05st-tests.tar.gz"
WORDDICT = "wordDict.txt"
VERBDICT = "verbDict.txt"
TRGDICT = "targetDict.txt"
WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"
UNK_IDX = 0

_SYN_VOCAB, _SYN_VERBS, _SYN_LABELS = 800, 60, 21


def load_dict(path):
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def _have_cache():
    return all(common.cached_file("conll05st", f)
               for f in (ARCHIVE, WORDDICT, VERBDICT, TRGDICT))


def get_dict():
    """(word_dict, verb_dict, label_dict) (conll05.py get_dict)."""
    if _have_cache():
        return (load_dict(common.cached_file("conll05st", WORDDICT)),
                load_dict(common.cached_file("conll05st", VERBDICT)),
                load_dict(common.cached_file("conll05st", TRGDICT)))
    word = {f"w{i}": i for i in range(_SYN_VOCAB)}
    verb = {f"v{i}": i for i in range(_SYN_VERBS)}
    label = {lbl: i for i, lbl in enumerate(
        ["O"] + [f"{b}-A{k}" for k in range(10) for b in ("B", "I")])}
    label["B-V"] = len(label)
    return word, verb, label


def corpus_reader(data_path, words_name=WORDS_NAME, props_name=PROPS_NAME):
    """Stream (sentence_words, predicate, iobes_labels) triples from the
    conll05st props format (conll05.py corpus_reader — '*'/'(A0*'/'*)'
    bracket runs converted to B-/I-/O tags)."""

    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentence, one_seg = [], []
                for word, label in itertools.zip_longest(words_file,
                                                         props_file):
                    word = word.decode().strip()
                    label = label.decode().strip().split()
                    if label:
                        sentence.append(word)
                        one_seg.append(label)
                        continue
                    # end of sentence: column 0 is the verb column, columns
                    # 1.. are per-predicate bracket tag runs
                    columns = list(zip(*one_seg)) if one_seg else []
                    if columns:
                        verbs = [v for v in columns[0] if v != "-"]
                        for vi, col in enumerate(columns[1:]):
                            tags, cur, inside = [], "O", False
                            ok = True
                            for tok in col:
                                if tok == "*":
                                    tags.append(f"I-{cur}" if inside
                                                else "O")
                                elif tok == "*)":
                                    tags.append(f"I-{cur}")
                                    inside = False
                                elif "(" in tok and ")" in tok:
                                    cur = tok[1:tok.find("*")]
                                    tags.append(f"B-{cur}")
                                    inside = False
                                elif "(" in tok:
                                    cur = tok[1:tok.find("*")]
                                    tags.append(f"B-{cur}")
                                    inside = True
                                else:
                                    ok = False
                                    break
                            if ok and vi < len(verbs):
                                yield sentence, verbs[vi], tags
                    sentence, one_seg = [], []
    return reader


def reader_creator(corpus, word_dict, predicate_dict, label_dict):
    """9-feature SRL construction (conll05.py reader_creator)."""

    def reader():
        for sentence, predicate, labels in corpus():
            if "B-V" not in labels:
                continue
            n = len(sentence)
            vi = labels.index("B-V")
            mark = [0] * n
            ctx = {}
            for off, key in ((-2, "n2"), (-1, "n1"), (0, "0"),
                             (1, "p1"), (2, "p2")):
                j = vi + off
                if 0 <= j < n:
                    mark[j] = 1
                    ctx[key] = sentence[j]
                else:
                    ctx[key] = "bos" if off < 0 else "eos"
            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctx_feats = [[word_dict.get(ctx[k], UNK_IDX)] * n
                         for k in ("n2", "n1", "0", "p1", "p2")]
            pred_idx = [predicate_dict.get(predicate, 0)] * n
            label_idx = [label_dict.get(t, label_dict.get("O", 0))
                         for t in labels]
            yield tuple([word_idx] + ctx_feats + [pred_idx, mark, label_idx])
    return reader


def _synthetic_corpus(split, seed, num):
    """Tagged sentences from a deterministic tag table (same learnable
    structure as synthetic.sequence_tagging), with one synthetic verb."""
    word_dict, verb_dict, label_dict = get_dict()
    labels = [lbl for lbl in label_dict if lbl != "B-V"]
    tag_of = np.random.RandomState(99).randint(0, len(labels), _SYN_VOCAB)

    def corpus():
        r = np.random.RandomState(seed)
        for _ in range(num):
            n = int(r.randint(6, 25))
            toks = r.randint(0, _SYN_VOCAB, n)
            vi = int(r.randint(n))
            words = [f"w{t}" for t in toks]
            tags = [labels[tag_of[t]] for t in toks]
            tags[vi] = "B-V"
            verb = f"v{toks[vi] % _SYN_VERBS}"
            yield words, verb, tags
    return common.synthetic_fallback(
        "conll05", split,
        reader_creator(corpus, word_dict, verb_dict, label_dict))


def test():
    """The public split (training data is licensed; the reference trains on
    the test split too, conll05.py test())."""
    if _have_cache():
        word_dict, verb_dict, label_dict = get_dict()
        corpus = corpus_reader(common.cached_file("conll05st", ARCHIVE))
        return common.real_data(
            reader_creator(corpus, word_dict, verb_dict, label_dict))
    return _synthetic_corpus("test", seed=41, num=2048)


def train():
    return test() if _have_cache() else _synthetic_corpus(
        "train", seed=40, num=4096)

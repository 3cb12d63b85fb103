"""The port's ``dataset`` package against ``paddle_tpu.dataset`` on the
CPU.

The readers are host-side numpy in both packages, so the contract is
exact: every reader of every module, for each split and format, yields
the reference's samples (same types, dtypes, shapes and bytes) with the
same ``provenance``,

- on the synthetic fallbacks (an empty ``DATA_HOME``), the large image
  sets (CIFAR's training splits, flowers) over a leading slice;
- on small files in each real format that the tests write under
  ``tmp_path``: idx gzip, the CIFAR tars, housing text, the imdb,
  imikolov and wmt14 tars, a movielens zip, the conll05 dictionaries and
  corpus, a sentiment directory, LETOR text, a VOC tar and a flowers tar
  with its ``.mat`` files. Word counts tie on purpose, so the
  dictionaries' ``(-count, word)`` order is what is tested.

Both packages are pointed at one directory (``common.DATA_HOME`` of
each) and their memoized dictionaries and metadata are cleared first:
``_dict_cache`` of imdb, imikolov and wmt14, ``movielens._meta`` and
``sentiment._cache`` keep their first answer whatever ``DATA_HOME``
says later, in both packages alike. ``split_to_recordio`` and the
modules' ``convert`` write byte-identical files in both packages. The
last class carries ``tests/test_datasets.py``'s cases over to the port
(its ``TestTripwires`` are in ``tests/test_torch_trainer.py``).
"""

import gzip
import io
import itertools
import logging
import pickle
import struct
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as JD
import paddle_tpu_torch.dataset as TD
from paddle_tpu_torch.dataset import (cifar, common, conll05, flowers, imdb,
                                      imikolov, mnist, movielens, mq2007,
                                      sentiment, uci_housing, voc2012, wmt14)

_END = object()


def same(a, b, where="sample"):
    """``a`` (the port's) is ``b`` (the reference's): equal types, and
    numpy arrays equal in dtype, shape and bytes."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), (where, type(a))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(b, dict):
        assert type(a) is type(b) and list(a) == list(b), where
        for k in b:
            same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def same_stream(treader, jreader, limit=None):
    """The two readers' streams (their first ``limit`` samples) are the
    same; returns the count."""
    assert treader.provenance == jreader.provenance
    n = 0
    pairs = itertools.zip_longest(itertools.islice(treader(), limit),
                                  itertools.islice(jreader(), limit),
                                  fillvalue=_END)
    for a, b in pairs:
        assert a is not _END and b is not _END, f"lengths differ at {n}"
        same(a, b, f"sample {n}")
        n += 1
    return n


@pytest.fixture
def home(tmp_path, monkeypatch):
    """Both packages' ``DATA_HOME`` at ``tmp_path``, their memoized
    dictionaries and metadata empty."""
    for D in (JD, TD):
        monkeypatch.setattr(D.common, "DATA_HOME", str(tmp_path))
        for m in (D.imdb, D.imikolov, D.wmt14):
            monkeypatch.setattr(m, "_dict_cache", {})
        monkeypatch.setattr(D.movielens, "_meta", None)
        monkeypatch.setattr(D.sentiment, "_cache", None)
    return tmp_path


def add_bytes(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def png(arr, mode=None):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


# --------------------------------------------------------------------------
# the real formats, written small
# --------------------------------------------------------------------------

def write_mnist(root):
    d = root / "mnist"
    d.mkdir()
    rng = np.random.RandomState(0)
    for images, labels, n in ((mnist.TRAIN_IMAGES, mnist.TRAIN_LABELS, 6),
                              (mnist.TEST_IMAGES, mnist.TEST_LABELS, 3)):
        with gzip.open(d / images, "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.randint(0, 256, (n, 28, 28), np.uint8).tobytes())
        with gzip.open(d / labels, "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.randint(0, 10, n).astype(np.uint8).tobytes())


def write_cifar(root):
    d = root / "cifar"
    d.mkdir()
    rng = np.random.RandomState(1)

    def batch(n, key, classes):
        return pickle.dumps({
            "data": rng.randint(0, 256, (n, 3072), np.uint8),
            key: [int(c) for c in rng.randint(0, classes, n)]})
    with tarfile.open(d / cifar.CIFAR10, "w:gz") as tf:
        add_bytes(tf, "cifar-10-batches-py/batches.meta", pickle.dumps({}))
        add_bytes(tf, "cifar-10-batches-py/data_batch_1",
                  batch(5, "labels", 10))
        add_bytes(tf, "cifar-10-batches-py/data_batch_2",
                  batch(4, "labels", 10))
        add_bytes(tf, "cifar-10-batches-py/test_batch",
                  batch(3, "labels", 10))
    with tarfile.open(d / cifar.CIFAR100, "w:gz") as tf:
        add_bytes(tf, "cifar-100-python/train", batch(6, "fine_labels", 100))
        add_bytes(tf, "cifar-100-python/test", batch(2, "fine_labels", 100))


def write_housing(root):
    d = root / "uci_housing"
    d.mkdir()
    rows = np.random.RandomState(2).rand(506, 14) * 50
    np.savetxt(d / "housing.data", rows, fmt="%.4f")


IMDB_DOCS = {
    # "movie" and "film" both pass the default cutoff (150) with equal
    # counts; at cutoff 0 most words tie
    "aclImdb/train/pos/0_9.txt": "A great movie! " + "movie film " * 40,
    "aclImdb/train/pos/1_8.txt": "Great, GREAT fun.\n" + "film movie " * 40,
    "aclImdb/train/neg/0_2.txt": "Dull; a dull film. " + "movie film " * 40,
    "aclImdb/train/neg/1_1.txt": "Not great: dull.\r\n" + "film movie " * 40,
    "aclImdb/train/neg/2_3.txt": "zebra yak " * 3,
    "aclImdb/train/unsup/0_0.txt": "never counted",
    "aclImdb/test/pos/0_10.txt": "great great movie",
    "aclImdb/test/neg/0_4.txt": "dull unseen words",
    "aclImdb/test/neg/1_2.txt": "film, film; film!",
}


def write_imdb(root):
    d = root / "imdb"
    d.mkdir()
    with tarfile.open(d / imdb.ARCHIVE, "w:gz") as tf:
        for name, text in IMDB_DOCS.items():
            add_bytes(tf, name, text.encode())


def write_imikolov(root):
    d = root / "imikolov"
    d.mkdir()
    rng = np.random.RandomState(3)
    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "<unk>"]

    def lines(n):
        # "a" and "b" once per line: their counts tie with <s> and <e>
        out = []
        for _ in range(n):
            k = int(rng.randint(0, 9))
            out.append(" ".join(["a"] + list(rng.choice(words, k)) + ["b"]))
        return ("\n".join(out) + "\n").encode()
    with tarfile.open(d / imikolov.ARCHIVE, "w:gz") as tf:
        add_bytes(tf, imikolov.TRAIN_FILE, lines(60))
        add_bytes(tf, imikolov.VALID_FILE, lines(12))


def write_sentiment(root):
    rng = np.random.RandomState(4)
    words = ["good", "bad", "plot", "actor", "it's", "scene", "boring"]
    for cat, n in (("neg", 5), ("pos", 4)):
        d = root / "sentiment" / sentiment.CORPUS_DIR / cat
        d.mkdir(parents=True)
        for i in range(n):
            text = " ".join(rng.choice(words, 12)) + ". Really, no!?"
            (d / f"cv{i:03d}_{cat}.txt").write_text(text)


def write_movielens(root):
    d = root / "movielens"
    d.mkdir()
    movies = ["1::Toy Story (1995)::Animation|Children's|Comedy",
              "2::The Story of the Toy (1996)::Comedy|Drama",
              "3::Heat::Action|Crime|Thriller",
              "5::Drama (2000)::Drama"]
    users = ["1::F::1::10::48067", "2::M::56::16::70072",
             "3::M::25::15::55117", "4::F::45::7::02460"]
    rng = np.random.RandomState(5)
    ratings = [f"{rng.choice([1, 2, 3, 4])}::{rng.choice([1, 2, 3, 5])}::"
               f"{rng.randint(1, 6)}::97830{i:04d}" for i in range(80)]
    with zipfile.ZipFile(d / movielens.ARCHIVE, "w") as z:
        for name, rows in (("movies", movies), ("users", users),
                           ("ratings", ratings)):
            z.writestr(f"ml-1m/{name}.dat",
                       ("\n".join(rows) + "\n").encode("latin1"))


CONLL_SENTENCES = [
    # (word, verb column, predicate columns...)
    [("The", "-", "(A0*"), ("cat", "-", "*)"), ("sat", "sit", "(V*)"),
     ("down", "-", "(AM-DIR*)")],
    [("He", "-", "(A0*)", "(A0*)"), ("said", "say", "(V*)", "*"),
     ("she", "-", "(A1*", "(A0*)"), ("left", "leave", "*", "(V*)"),
     ("early", "-", "*)", "(AM-TMP*)")],
    # a malformed tag run: this predicate is skipped
    [("Bad", "-", "(A0*"), ("run", "run", "junk"), ("here", "-", "*)")],
    [("Dogs", "-", "(A0*)"), ("bark", "bark", "(V*)")],
]


def write_conll05(root):
    d = root / "conll05st"
    d.mkdir()
    words, props = [], []
    for sent in CONLL_SENTENCES:
        for w, *cols in sent:
            words.append(w)
            props.append("\t".join(cols))
        words.append("")
        props.append("")
    with tarfile.open(d / conll05.ARCHIVE, "w:gz") as tf:
        add_bytes(tf, conll05.WORDS_NAME,
                  gzip.compress(("\n".join(words) + "\n").encode()))
        add_bytes(tf, conll05.PROPS_NAME,
                  gzip.compress(("\n".join(props) + "\n").encode()))
    (d / conll05.WORDDICT).write_text(
        "\n".join(["<unk>", "the", "cat", "sat", "he", "said", "she",
                   "left", "bos", "eos", "dogs"]) + "\n")
    (d / conll05.VERBDICT).write_text("sit\nsay\nleave\nbark\n")
    (d / conll05.TRGDICT).write_text(
        "\n".join(["B-A0", "I-A0", "B-A1", "I-A1", "B-V", "O",
                   "B-AM-TMP"]) + "\n")


def write_wmt14(root):
    d = root / "wmt14"
    d.mkdir()
    words = ["le", "chat", "sits", "the", "cat", "sat", "un", "a"]
    head = ["<s>", "<e>", "<unk>"]
    long_line = " ".join(["le"] * 81) + "\tthe\n"
    files = {
        "wmt14/src.dict": "\n".join(head + words) + "\n",
        "wmt14/trg.dict": "\n".join(head + words[::-1]) + "\n",
        "wmt14/train/train": ("le chat\tthe cat\nle chat sits\tthe cat sat\n"
                              "no tab here\n" + long_line +
                              "un chat\ta cat\n"),
        "wmt14/test/test": "le\tthe\nun\ta\n",
        "wmt14/gen/gen": "le chat\tthe cat\n",
    }
    with tarfile.open(d / wmt14.ARCHIVE, "w:gz") as tf:
        for name, text in files.items():
            add_bytes(tf, name, text.encode())


def write_mq2007(root):
    fold = root / "mq2007" / "MQ2007" / "Fold1"
    fold.mkdir(parents=True)
    rng = np.random.RandomState(6)
    for name, groups in (("train.txt", ((10, [2, 0, 1, 1]), (11, [0, 0]),
                                        (12, [1, 2, 2]))),
                         ("test.txt", ((20, [1, 0]), (21, [2, 2, 0])))):
        lines = []
        for qid, rels in groups:
            for r in rels:
                # feature 47 is out of range and dropped
                feats = " ".join(f"{k}:{rng.rand():.6f}"
                                 for k in range(1, 48))
                lines.append(f"{r} qid:{qid} {feats} #docid = d{qid}")
            lines.append("")
        (fold / name).write_text("\n".join(lines) + "\n")


def write_voc2012(root):
    d = root / "voc2012"
    d.mkdir()
    rng = np.random.RandomState(7)
    keys = ["2007_000032", "2007_000039", "2007_000063"]
    with tarfile.open(d / voc2012.ARCHIVE, "w") as tf:
        for split, ks in (("trainval", keys), ("train", keys[:2]),
                          ("val", keys[2:])):
            add_bytes(tf, voc2012.SET_FILE.format(split),
                      ("\n".join(ks) + "\n").encode())
        for i, k in enumerate(keys):
            h, w = 12 + 2 * i, 16 - i
            add_bytes(tf, voc2012.DATA_FILE.format(k),
                      png(rng.randint(0, 256, (h, w, 3), np.uint8)))
            add_bytes(tf, voc2012.LABEL_FILE.format(k),
                      png(rng.randint(0, voc2012.NUM_CLASSES, (h, w),
                                      np.uint8), "L"))


def write_flowers(root):
    import scipy.io as scio
    d = root / "flowers"
    d.mkdir()
    rng = np.random.RandomState(8)
    with tarfile.open(d / flowers.DATA_ARCHIVE, "w:gz") as tf:
        add_bytes(tf, "jpg/readme.txt", b"not an image")
        for i, (h, w) in enumerate(((40, 30), (30, 50), (64, 64), (20, 36),
                                    (36, 20), (50, 40)), start=1):
            add_bytes(tf, f"jpg/image_{i:05d}.jpg",
                      png(rng.randint(0, 256, (h, w, 3), np.uint8)))
    scio.savemat(d / flowers.LABEL_FILE,
                 {"labels": np.array([[1, 5, 102, 3, 3, 7]])})
    scio.savemat(d / flowers.SETID_FILE,
                 {"tstid": np.array([[1, 2, 3]]), "trnid": np.array([[4, 5]]),
                  "valid": np.array([[6]])})


WRITERS = {"mnist": write_mnist, "cifar": write_cifar,
           "uci_housing": write_housing, "imdb": write_imdb,
           "imikolov": write_imikolov, "sentiment": write_sentiment,
           "movielens": write_movielens, "conll05": write_conll05,
           "wmt14": write_wmt14, "mq2007": write_mq2007,
           "voc2012": write_voc2012, "flowers": write_flowers}


NGRAM, SEQ = imikolov.DataType.NGRAM, imikolov.DataType.SEQ

# (module, call on the module, leading slice compared or None)
READERS = [
    ("mnist", lambda m: m.train(), None),
    ("mnist", lambda m: m.test(), None),
    ("cifar", lambda m: m.train10(), 512),
    ("cifar", lambda m: m.test10(), None),
    ("cifar", lambda m: m.train100(), 512),
    ("cifar", lambda m: m.test100(), None),
    ("uci_housing", lambda m: m.train(), None),
    ("uci_housing", lambda m: m.test(), None),
    ("imdb", lambda m: m.train(), None),
    ("imdb", lambda m: m.test(), None),
    ("imdb", lambda m: m.train(m.build_dict(cutoff=0)), None),
    ("imikolov", lambda m: m.train(), None),
    ("imikolov", lambda m: m.test(n=3), None),
    ("imikolov", lambda m: m.train(n=0, data_type=m.DataType.SEQ), None),
    ("imikolov", lambda m: m.test(n=6, data_type=m.DataType.SEQ), None),
    ("imikolov", lambda m: m.train(m.build_dict(0), n=2), None),
    ("sentiment", lambda m: m.train(), None),
    ("sentiment", lambda m: m.test(), None),
    ("movielens", lambda m: m.train(), None),
    ("movielens", lambda m: m.test(), None),
    ("conll05", lambda m: m.train(), None),
    ("conll05", lambda m: m.test(), None),
    ("wmt14", lambda m: m.train(), None),
    ("wmt14", lambda m: m.test(), None),
    ("wmt14", lambda m: m.gen(), None),
    ("wmt14", lambda m: m.train(dict_size=5), None),
    ("mq2007", lambda m: m.train("pointwise"), None),
    ("mq2007", lambda m: m.train("pairwise"), None),
    ("mq2007", lambda m: m.train("listwise"), None),
    ("mq2007", lambda m: m.test("pointwise"), None),
    ("mq2007", lambda m: m.test("pairwise"), None),
    ("mq2007", lambda m: m.test("listwise"), None),
    ("voc2012", lambda m: m.train(), None),
    ("voc2012", lambda m: m.test(), None),
    ("voc2012", lambda m: m.val(), None),
    ("flowers", lambda m: m.train(), 16),
    ("flowers", lambda m: m.test(), 16),
    ("flowers", lambda m: m.valid(), 16),
]
READER_IDS = [f"{m}-{i}" for i, (m, _, _) in enumerate(READERS)]

# the dictionaries and metadata each module exposes
DICTS = [
    ("imdb", lambda m: m.build_dict()),
    ("imdb", lambda m: m.build_dict(cutoff=0)),
    ("imdb", lambda m: m.build_dict(m._TEST_POS, cutoff=0)),
    ("imdb", lambda m: m.word_dict()),
    ("imikolov", lambda m: m.build_dict()),
    ("imikolov", lambda m: m.build_dict(min_word_freq=0)),
    ("sentiment", lambda m: m.get_word_dict()),
    ("conll05", lambda m: m.get_dict()),
    ("wmt14", lambda m: m.get_dict()),
    ("wmt14", lambda m: m.get_dict(dict_size=5, reverse=False)),
    ("movielens", lambda m: (m.get_movie_title_dict(), m.movie_categories(),
                             m.max_movie_id(), m.max_user_id(),
                             m.max_job_id())),
    ("movielens", lambda m: {k: [v.value()] for k, v in
                             m.user_info().items()}),
    ("movielens", lambda m: {k: [v.index, v.categories, v.title]
                             for k, v in m.movie_info().items()}),
]
DICT_IDS = [f"{m}-{i}" for i, (m, _) in enumerate(DICTS)]


def _shrunk_sentiment(monkeypatch):
    # 9 fixture reviews: split them 4 / rest as the real corpus splits
    # 1600 / 400
    for D in (JD, TD):
        monkeypatch.setattr(D.sentiment, "NUM_TRAINING_INSTANCES", 4)


@pytest.mark.parametrize("name,call,limit", READERS, ids=READER_IDS)
def test_synthetic_streams_equal(home, name, call, limit):
    t, j = call(getattr(TD, name)), call(getattr(JD, name))
    assert t.provenance == "synthetic"
    assert same_stream(t, j, limit) > 0


@pytest.mark.parametrize("name,call,limit", READERS, ids=READER_IDS)
def test_real_format_streams_equal(home, monkeypatch, name, call, limit):
    WRITERS[name](home)
    _shrunk_sentiment(monkeypatch)
    t, j = call(getattr(TD, name)), call(getattr(JD, name))
    assert t.provenance == "real"
    n = same_stream(t, j, limit)
    assert n > 0
    # a second pass reads the files again, as the reference does
    assert same_stream(t, j, limit) == n


@pytest.mark.parametrize("real", [False, True], ids=["synthetic", "real"])
@pytest.mark.parametrize("name,call", DICTS, ids=DICT_IDS)
def test_dictionaries_equal(home, name, call, real):
    if real:
        WRITERS[name](home)
    same(call(getattr(TD, name)), call(getattr(JD, name)))


def test_dictionaries_rank_ties_by_word(home):
    """The fixtures' tied counts rank by (-count, word), '<unk>' last."""
    write_imdb(home)
    d = imdb.build_dict()
    assert list(d) == ["film", "movie", "<unk>"]
    write_imikolov(home)
    d = imikolov.build_dict()
    assert list(d)[:4] == ["<e>", "<s>", "a", "b"]
    assert list(d)[-1] == "<unk>"


def test_dict_caches_keep_their_first_answer(home):
    """Memoized across DATA_HOME changes, in both packages alike: the
    synthetic dictionary built before the files appear stays."""
    first = {D.__name__: D.imdb.build_dict() for D in (TD, JD)}
    write_imdb(home)
    for D in (TD, JD):
        assert D.imdb.build_dict() is first[D.__name__]
        assert "w0" in first[D.__name__]
        assert D.imdb.train().provenance == "real"


def test_synthetic_warns_once_per_module_and_split(home, monkeypatch,
                                                   caplog):
    monkeypatch.setattr(common, "_warned", set())
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        mnist.train()
        mnist.train()
        mnist.test()
    msgs = [r.getMessage() for r in caplog.records
            if "SYNTHETIC" in r.getMessage()]
    assert len(msgs) == 2
    assert "mnist.train" in msgs[0] and "mnist.test" in msgs[1]


def test_cached_file_md5(home):
    write_housing(home)
    path = common.cache_path("uci_housing", "housing.data")
    import hashlib
    md5 = hashlib.md5(open(path, "rb").read()).hexdigest()
    for D in (TD, JD):
        assert D.common.cached_file("uci_housing", "housing.data",
                                    md5) == path
        assert D.common.cached_file("uci_housing", "housing.data",
                                    "0" * 32) is None
        assert D.common.cached_file("uci_housing", "missing") is None


def _files(paths):
    return [(p.rsplit("/", 1)[-1], open(p, "rb").read()) for p in paths]


def _mixed():
    rng = np.random.RandomState(9)
    for i in range(23):
        yield (rng.rand(5).astype(np.float32), [int(v) for v in
                                                 rng.randint(0, 9, i % 4)],
               i)


@pytest.mark.parametrize("pattern", ["c-%d.rio", "c-{}.rio", "c-%05d"])
def test_split_to_recordio_byte_identical(tmp_path, pattern):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = TD.common.split_to_recordio(_mixed, str(tmp_path / "t" / pattern),
                                     line_count=5)
    jp = JD.common.split_to_recordio(_mixed, str(tmp_path / "j" / pattern),
                                     line_count=5)
    assert len(tp) == 5
    assert _files(tp) == _files(jp)


CONVERTS = ["mnist", "cifar", "uci_housing", "imdb", "imikolov",
            "sentiment", "movielens"]


@pytest.mark.parametrize("name", CONVERTS)
def test_convert_byte_identical(home, monkeypatch, name):
    """Each module's ``convert`` over the fixture files (real data)."""
    WRITERS[name](home)
    _shrunk_sentiment(monkeypatch)
    tp = getattr(TD, name).convert(str(home / "out_t"), line_count=7)
    jp = getattr(JD, name).convert(str(home / "out_j"), line_count=7)
    assert tp and _files(tp) == _files(jp)


def test_convert_synthetic_reads_back(home):
    """``convert`` of a synthetic set, read back through the port's
    ``reader.creator.recordio``, yields the in-memory reader's samples."""
    from paddle_tpu_torch.reader import creator
    tp = uci_housing.convert(str(home / "out_t"), line_count=100)
    jp = JD.uci_housing.convert(str(home / "out_j"), line_count=100)
    assert _files(tp) == _files(jp)
    train = [p for p in tp if "uci_housing_train" in p]
    got = list(creator.recordio(train)())
    same(got, list(uci_housing.train()()))


def test_port_names_match_the_reference():
    """Each module's public names are the reference's."""
    for name in ("common", "synthetic", "mnist", "cifar", "uci_housing",
                 "imdb", "imikolov", "sentiment", "movielens", "conll05",
                 "wmt14", "mq2007", "voc2012", "flowers"):
        jm, tm = getattr(JD, name), getattr(TD, name)
        jnames = {k for k in vars(jm) if not k.startswith("__")}
        tnames = {k for k in vars(tm) if not k.startswith("__")}
        assert jnames == tnames, (name, jnames ^ tnames)


# --------------------------------------------------------------------------
# tests/test_datasets.py's cases, against the port
# --------------------------------------------------------------------------

def take(reader_fn, n):
    return list(itertools.islice(reader_fn(), n))


class TestProvenance:
    def test_synthetic_fallbacks_are_labelled(self):
        for reader in (mnist.train(), cifar.train10(), uci_housing.train(),
                       imdb.train(), movielens.train(), conll05.train(),
                       wmt14.train(), sentiment.train(), voc2012.train(),
                       flowers.train(), mq2007.train()):
            assert getattr(reader, "provenance", None) in (
                "synthetic", "real")

    def test_real_data_marks(self, home):
        # fabricate a tiny idx-format MNIST cache and check provenance flips
        d = home / "mnist"
        d.mkdir()
        imgs = np.random.RandomState(0).randint(
            0, 255, (4, 28, 28), np.uint8)
        labs = np.arange(4, dtype=np.uint8)
        with gzip.open(d / mnist.TRAIN_IMAGES, "wb") as f:
            f.write(struct.pack(">IIII", 2051, 4, 28, 28))
            f.write(imgs.tobytes())
        with gzip.open(d / mnist.TRAIN_LABELS, "wb") as f:
            f.write(struct.pack(">II", 2049, 4))
            f.write(labs.tobytes())
        r = mnist.train()
        assert r.provenance == "real"
        samples = take(r, 4)
        assert len(samples) == 4
        assert samples[0][0].shape == (784,)
        assert [s[1] for s in samples] == [0, 1, 2, 3]


class TestSchemas:
    def test_movielens_schema(self, home):
        s = take(movielens.train(), 3)[0]
        uid, gender, age, job, mid, cats, title, rating = s
        assert gender in (0, 1)
        assert 0 <= age < len(movielens.age_table)
        assert isinstance(cats, list) and isinstance(title, list)
        assert isinstance(rating, list) and len(rating) == 1
        assert -5.0 <= rating[0] <= 5.0
        assert movielens.max_user_id() >= uid
        assert movielens.max_movie_id() >= mid
        assert movielens.max_job_id() >= job

    def test_conll05_schema(self, home):
        word_d, verb_d, label_d = conll05.get_dict()
        s = take(conll05.train(), 2)[0]
        assert len(s) == 9
        n = len(s[0])
        for feat in s:
            assert len(feat) == n
        assert len(set(s[1])) == 1 and len(set(s[6])) == 1
        assert set(s[7]) <= {0, 1}
        assert all(0 <= t < len(label_d) for t in s[8])

    def test_wmt14_schema(self, home):
        src, trg, trg_next = take(wmt14.train(dict_size=1000), 2)[0]
        assert trg[0] == 0
        assert trg_next[-1] == 1
        assert trg[1:] == trg_next[:-1]

    def test_sentiment_schema(self, home):
        toks, lbl = take(sentiment.train(), 2)[0]
        assert lbl in (0, 1) and all(isinstance(t, (int, np.integer))
                                     for t in toks)

    def test_voc2012_schema(self, home):
        img, mask = take(voc2012.train(), 1)[0]
        assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
        assert mask.shape == img.shape[:2]
        assert mask.max() < voc2012.NUM_CLASSES

    def test_flowers_schema(self, home):
        x, y = take(flowers.train(), 1)[0]
        assert x.shape == (flowers.IMG_DIM,)
        assert 0 <= y < 102

    def test_mq2007_formats(self, home):
        lbl, better, worse = take(mq2007.train("pairwise"), 1)[0]
        assert better.shape == (mq2007.FEATURE_DIM,)
        s, v = take(mq2007.train("listwise"), 1)[0]
        assert v.shape == (len(s), mq2007.FEATURE_DIM)
        score, vec = take(mq2007.train("pointwise"), 1)[0]
        assert vec.shape == (mq2007.FEATURE_DIM,)
        with pytest.raises(ValueError, match="unknown format"):
            take(mq2007.train("triplewise"), 1)

    def test_imikolov_seq_fallback_schema(self, home):
        src, trg = take(imikolov.train(n=0, data_type=SEQ), 2)[0]
        assert src[1:] == trg[:-1]

    def test_imdb_word_dict_has_unk(self, home):
        d = imdb.build_dict()
        assert "<unk>" in d


class TestRealParsers:
    def test_wmt14_tar_roundtrip(self, home, tmp_path_factory):
        d = home / "wmt14"
        d.mkdir()
        root = tmp_path_factory.mktemp("build")
        (root / "train").mkdir(parents=True)
        (root / "test").mkdir()
        words = ["le", "chat", "sits", "the", "cat", "sat"]
        (root / "src.dict").write_text(
            "\n".join(["<s>", "<e>", "<unk>"] + words) + "\n")
        (root / "trg.dict").write_text(
            "\n".join(["<s>", "<e>", "<unk>"] + words) + "\n")
        (root / "train" / "train").write_text(
            "le chat\tthe cat\nle chat sits\tthe cat sat\n")
        (root / "test" / "test").write_text("le\tthe\n")
        with tarfile.open(d / wmt14.ARCHIVE, "w:gz") as tf:
            for p in root.rglob("*"):
                if p.is_file():
                    tf.add(p, arcname=str(p.relative_to(root)))
        r = wmt14.train(dict_size=100)
        assert r.provenance == "real"
        samples = list(r())
        assert len(samples) == 2
        src, trg, trg_next = samples[0]
        assert src[0] == 0 and src[-1] == 1       # <s> ... <e>
        assert trg_next[-1] == 1

    def test_mq2007_letor_parser(self, home):
        fold = home / "mq2007" / "MQ2007" / "Fold1"
        fold.mkdir(parents=True)
        lines = []
        for qid, rels in ((10, [2, 0]), (11, [1, 1, 0])):
            for r in rels:
                feats = " ".join(f"{k}:{0.1*k}" for k in range(1, 47))
                lines.append(f"{r} qid:{qid} {feats} #docid x")
        (fold / "train.txt").write_text("\n".join(lines) + "\n")
        r = mq2007.train("listwise")
        assert r.provenance == "real"
        qs = list(r())
        assert len(qs) == 2
        assert len(qs[0][0]) == 2 and len(qs[1][0]) == 3
        # pairwise emits only score-ordered pairs
        pairs = list(mq2007.train("pairwise")())
        assert len(pairs) == 1 + 2       # (2>0), (1>0)x2


class TestCommonHelpers:
    def test_split_streams(self):
        chunks = list(common.split(lambda: iter(range(10)), 4))
        assert chunks == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]

    def test_split_to_recordio_requires_slot(self, tmp_path):
        with pytest.raises(ValueError, match="slot"):
            common.split_to_recordio(lambda: iter(range(4)),
                                     str(tmp_path / "out.rio"))

    def test_split_to_recordio(self, tmp_path):
        from paddle_tpu_torch.runtime import recordio
        paths = common.split_to_recordio(
            lambda: iter(range(10)), str(tmp_path / "c-%d.rio"),
            line_count=4)
        assert len(paths) == 3
        got = [r for p in paths for r in recordio.read_records(p)]
        assert got == list(range(10))


def test_new_modules_import_without_jax(tmp_path):
    """In a fresh process, importing the port's datasets and small
    modules pulls in no module of ``jax`` or ``paddle_tpu`` beyond what
    the interpreter had loaded before them."""
    import subprocess
    import sys
    from pathlib import Path
    repo = str(Path(__file__).resolve().parent.parent)
    code = (
        "import sys\n"
        "def ref():\n"
        "    return {m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')}\n"
        "before = ref()\n"
        "import paddle_tpu_torch as T\n"
        "from paddle_tpu_torch import dataset, image, plot, version\n"
        "from paddle_tpu_torch.dataset import (cifar, common, conll05,\n"
        "    flowers, imdb, imikolov, mnist, movielens, mq2007, sentiment,\n"
        "    synthetic, uci_housing, voc2012, wmt14)\n"
        "T.cli = __import__('paddle_tpu_torch.cli').cli\n"
        "print(sorted(ref() - before))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env={"PYTHONPATH": repo, "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"

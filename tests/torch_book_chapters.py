"""The nine chapters of ``tests/test_book.py``, built once for any package
``P`` with the v2 layer API (the JAX package or the port).

``chapter(name, P, w)`` builds one chapter's network, reader, batch size,
optimizer maker and feeding in ``P``, at the widths in ``w`` (``SMALL``
for the CPU tests, the builders' defaults in ``chip_smoke.py``'s
``book:`` phase). The reader is the dataset's whole reader; a caller
that trains on a prefix wraps it. This module imports neither package:
the CPU tests and the card's smoke run share its networks.
"""

import numpy as np

# the widths the CPU tests train at
SMALL = {"lstm_hidden": 32, "lstm_emb": 32, "resnet_depth": 8,
         "image_batch": 32, "wmt_dict": 200, "wmt_dim": 32,
         "wmt_batch": 16}

SRL_SLOTS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb", "mark")
QS_VOCAB = 2000         # ``demos/quick_start/train_text.py``'s VOCAB


class Chapter:
    """A chapter as the reference test builds it: its cost, reader, batch
    size, optimizer maker (each call makes a new optimizer), feeding and
    extra layers."""

    def __init__(self, cost, reader, batch, opt, feeding=None, extra=()):
        self.cost, self.reader, self.batch = cost, reader, batch
        self.opt, self.feeding, self.extra = opt, feeding, list(extra)


def _adam(P, lr, **kw):
    return lambda: P.optimizer.Adam(learning_rate=lr, **kw)


def fit_a_line(P, w):
    L = P.layer
    x = L.data("x", P.data_type.dense_vector(
        P.dataset.uci_housing.FEATURE_DIM))
    y = L.data("y", P.data_type.dense_vector(1))
    pred = L.fc(x, 1, act=None, name="fal_fc")
    cost = L.square_error_cost(pred, y, name="fal_cost")
    return Chapter(cost, P.dataset.uci_housing.train(), 32, _adam(P, 5e-2))


def word2vec(P, w):
    L, N = P.layer, 5
    vocab = P.dataset.imikolov.VOCAB_SIZE
    words = [L.data(f"w{i}", P.data_type.integer_value(vocab))
             for i in range(N - 1)]
    target = L.data("wt", P.data_type.integer_value(vocab))
    embs = [L.embedding(x, 16, name=f"w2v_emb{i}",
                        param_attr=L.ParamAttr(name="w2v_emb.w"))
            for i, x in enumerate(words)]
    h = L.fc(L.concat(embs, name="w2v_ctx"), 32,
             act=P.activation.Relu(), name="w2v_h")
    out = L.fc(h, vocab, act=P.activation.Softmax(), name="w2v_out")
    cost = L.classification_cost(out, target, name="w2v_cost")
    return Chapter(cost, P.dataset.imikolov.train(n=N), 64, _adam(P, 1e-2),
                   feeding={f"w{i}": i for i in range(N - 1)} | {"wt": 4})


def recommender(P, w):
    L, ml = P.layer, P.dataset.movielens
    uid = L.data("uid", P.data_type.integer_value(ml.max_user_id() + 1))
    mid = L.data("mid", P.data_type.integer_value(ml.max_movie_id() + 1))
    rating = L.data("rating", P.data_type.dense_vector(1))
    uvec = L.fc(L.embedding(uid, 16, name="rec_uemb"), 16,
                act=P.activation.Relu(), name="rec_ufc")
    mvec = L.fc(L.embedding(mid, 16, name="rec_memb"), 16,
                act=P.activation.Relu(), name="rec_mfc")
    sim = L.cos_sim(uvec, mvec, scale=5.0, name="rec_sim")
    cost = L.square_error_cost(sim, rating, name="rec_cost")

    def reader():
        for s in ml.train()():
            yield s[0], s[4], np.asarray(s[7], np.float32)
    return Chapter(cost, reader, 64, _adam(P, 1e-2),
                   feeding={"uid": 0, "mid": 1, "rating": 2})


def sentiment(P, w):
    L = P.layer
    vocab = len(P.dataset.imdb.word_dict())
    words = L.data("words", P.data_type.integer_value_sequence(vocab))
    lbl = L.data("label", P.data_type.integer_value(2))
    out = P.models.text.lstm_text_classification(
        words, hidden_dim=w["lstm_hidden"], class_num=2,
        emb_dim=w["lstm_emb"])
    cost = L.classification_cost(out, lbl, name="us_cost")
    err = P.evaluator.classification_error(out, lbl, name="us_err")
    return Chapter(cost, P.dataset.imdb.train(), 32, _adam(P, 1e-2),
                   extra=[err])


def image(P, w):
    L = P.layer
    img = L.data("image", P.data_type.dense_vector(3 * 32 * 32))
    lbl = L.data("label", P.data_type.integer_value(10))
    out = P.models.resnet.resnet_cifar10(img, depth=w["resnet_depth"],
                                         class_num=10)
    cost = L.classification_cost(out, lbl, name="ic_cost")
    return Chapter(cost, P.dataset.cifar.train10(), w["image_batch"],
                   _adam(P, 1e-3))


def srl(P, w):
    L = P.layer
    word_d, verb_d, label_d = P.dataset.conll05.get_dict()
    sizes = dict.fromkeys(SRL_SLOTS[:6], len(word_d)) | {
        "verb": len(verb_d), "mark": 2}
    seqs = {n: L.data(f"srl_{n}", P.data_type.integer_value_sequence(s))
            for n, s in sizes.items()}
    target = L.data("srl_target",
                    P.data_type.integer_value_sequence(len(label_d)))
    embs = [L.embedding(seqs[n], 16, name=f"srl_emb_{n}") for n in SRL_SLOTS]
    hidden = L.fc(L.concat(embs, name="srl_concat"), 32,
                  act=P.activation.Tanh(), name="srl_hidden")
    feat = L.fc(hidden, len(label_d), act=None, name="srl_feat")
    crf = L.crf_layer(feat, target, size=len(label_d), name="srl_crf")
    feeding = {f"srl_{n}": i for i, n in enumerate(SRL_SLOTS)}
    feeding["srl_target"] = 8
    return Chapter(crf, P.dataset.conll05.train(), 16, _adam(P, 5e-3),
                   feeding=feeding)


def translation(P, w):
    d, dim = w["wmt_dict"], w["wmt_dim"]
    cost = P.models.seq2seq.seq2seq_train(
        d, d, word_vec_dim=dim, encoder_size=dim, decoder_size=dim)
    return Chapter(
        cost, P.dataset.wmt14.train(d), w["wmt_batch"],
        _adam(P, 5e-3, gradient_clipping_threshold=5.0),
        feeding={"source_language_word": 0, "target_language_word": 1,
                 "target_language_next_word": 2})


def learn_to_rank(P, w):
    """Pairs from the first 256 pairwise samples, shuffled with seed 1
    (each call of the reader draws a new order)."""
    L = P.layer
    dim = P.dataset.mq2007.FEATURE_DIM
    shared = L.ParamAttr(name="ltr.w")
    better = L.data("ltr_better", P.data_type.dense_vector(dim))
    worse = L.data("ltr_worse", P.data_type.dense_vector(dim))
    lbl = L.data("ltr_label", P.data_type.dense_vector(1))
    sb = L.fc(better, 1, act=None, param_attr=shared, bias_attr=False,
              name="ltr_sb")
    sw = L.fc(worse, 1, act=None, param_attr=shared, bias_attr=False,
              name="ltr_sw")
    cost = L.rank_cost(sb, sw, lbl, name="ltr_cost")

    def raw():
        for lab, b, x in P.reader.firstn(
                P.dataset.mq2007.train("pairwise"), 256)():
            yield b, x, [float(np.asarray(lab).reshape(-1)[0])]
    return Chapter(cost, P.reader.shuffle(raw, buf_size=256, seed=1), 32,
                   _adam(P, 1e-3),
                   feeding={"ltr_better": 0, "ltr_worse": 1, "ltr_label": 2})


def quick_start(P, w, cost=None):
    """``demos/quick_start/train_text.py``'s ``build("bow")`` over the
    first 256 samples of imdb's reader as sparse sequences; ``cost`` in
    place of the network built here (the demo's own, in the JAX
    package)."""
    if cost is None:
        L = P.layer
        lbl = L.data("label", P.data_type.integer_value(2))
        words = L.data("words", P.data_type.sparse_binary_vector_sequence(
            QS_VOCAB))
        h = L.fc(words, 64, act=P.activation.Relu(), name="qs_fc")
        pooled = L.pool(h, pooling_type=P.pooling.Sum())
        out = L.fc(pooled, 2, act=P.activation.Softmax(), name="qs_out")
        cost = L.classification_cost(out, lbl, name="qs_cost")
    word_idx = {f"w{i}": i for i in range(QS_VOCAB - 1)}
    word_idx["<unk>"] = QS_VOCAB - 1
    imdb = P.dataset.imdb.train(word_idx)

    def sparse_seq():
        for words, label in imdb():
            yield [[x] for x in words], label
    return Chapter(cost, P.reader.firstn(sparse_seq, 256), 64,
                   _adam(P, 2e-3))


BUILDERS = {"fit_a_line": fit_a_line, "word2vec": word2vec,
            "recommender": recommender, "sentiment": sentiment,
            "image": image, "srl": srl, "translation": translation,
            "learn_to_rank": learn_to_rank, "quick_start": quick_start}


def chapter(name, P, w=SMALL, **kw):
    """Chapter ``name`` built in package ``P`` at widths ``w``."""
    return BUILDERS[name](P, w, **kw)

"""The port's model zoo against ``paddle_tpu``'s on the CPU.

Every builder's parameter names and shapes are the JAX package's exactly
(ResNet-50: 25.5M parameters, 53 batch norms; GoogLeNet, AlexNet, VGG,
smallnet / LeNet-5, the text models, seq2seq, CTR); tiny forwards (and
gradients) within 1e-4 of max(1, max|JAX value|), the JAX package's
parameters carried across (``tests/torch_layers_util.py``); the train
steps of ``tests/test_models.py`` through both trainers; and the
single-card cases of ``tests/test_seq2seq.py`` and ``tests/test_ctr.py``.
``test_ctr.py::test_sharded_matches_single_device`` runs on gloo ranks
in ``tests/test_torch_spmd.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.models  # noqa: F401
import paddle_tpu.trainer  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.models  # noqa: F401
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu.utils.rng import KeySource as JKeySource
from tests.torch_layers_util import (Net, both_values, carry,  # noqa: F401
                                    keep_global_seed)

pytestmark = pytest.mark.usefixtures("keep_global_seed")

TOL = 1e-4


def _same_specs(jout, tout):
    """Parameter and state specs equal in name and shape; returns the
    port's topology."""
    jt = J.topology.Topology(jout)
    tt = T.topology.Topology(tout)
    for get in ("param_specs", "state_specs"):
        js = [(s.name, tuple(s.shape)) for s in getattr(jt, get)()]
        ts = [(s.name, tuple(s.shape)) for s in getattr(tt, get)()]
        assert ts == js, get
    return tt


def _image(P, dim):
    return P.layer.data("image", P.data_type.dense_vector(dim))


def _n_params(topo):
    return sum(int(np.prod(s.shape)) for s in topo.param_specs())


@pytest.mark.parametrize("s2d,fused", [(False, False), (True, False),
                                       (False, True), (False, "int8")])
def test_resnet50_structure(s2d, fused):
    def build(P):
        return P.models.resnet.resnet_imagenet(
            _image(P, 3 * 224 * 224), depth=50, stem_space_to_depth=s2d,
            fused_bn=fused)
    tt = _same_specs(build(J), build(T))
    assert 24e6 < _n_params(tt) < 27e6
    bn = sum(1 for l in tt.layers if l.layer_type in ("batch_norm",
                                                      "img_conv_bn"))
    assert bn == 53, bn


@pytest.mark.parametrize("name,dim,build,lo,hi", [
    ("googlenet", 3 * 224 * 224,
     lambda P, x: P.models.googlenet.googlenet(x), 5e6, 9e6),
    ("alexnet", 3 * 227 * 227, lambda P, x: P.models.alexnet.alexnet(x),
     55e6, 65e6),
    ("vgg16", 3 * 224 * 224, lambda P, x: P.models.vgg.vgg16(x),
     130e6, 145e6),
    ("vgg19", 3 * 224 * 224, lambda P, x: P.models.vgg.vgg19(x),
     135e6, 150e6),
    ("resnet101", 3 * 224 * 224,
     lambda P, x: P.models.resnet.resnet_imagenet(x, depth=101), 40e6, 50e6),
    ("resnet18", 3 * 224 * 224,
     lambda P, x: P.models.resnet.resnet_imagenet(x, depth=18), 11e6, 12.5e6),
])
def test_imagenet_builders_match(name, dim, build, lo, hi):
    tt = _same_specs(build(J, _image(J, dim)), build(T, _image(T, dim)))
    assert lo < _n_params(tt) < hi, _n_params(tt)


def test_smallnet_and_lenet_forward():
    def build(P):
        a = P.models.smallnet.smallnet(_image(P, 3 * 32 * 32))
        m = P.layer.data("mnist", P.data_type.dense_vector(784))
        return [a, P.models.smallnet.lenet5(m)]
    net = Net(build, init="numpy")
    rng = np.random.RandomState(0)
    jf, tf = both_values({"image": rng.rand(2, 3 * 32 * 32).astype(
        np.float32), "mnist": rng.rand(2, 784).astype(np.float32)})
    net.check(jf, tf, atol=TOL, grad=True)


def test_resnet_cifar_forward_and_gradients():
    def build(P):
        return P.models.resnet.resnet_cifar10(_image(P, 3 * 32 * 32),
                                              depth=8, width=8)
    net = Net(build, init="numpy")
    x = np.random.RandomState(1).randn(2, 3 * 32 * 32).astype(np.float32)
    j, t = net.check(*both_values({"image": x}), atol=TOL, grad=True,
                     is_training=True)
    probs = t[0]["rc_fc"].array.detach().numpy()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("fused", [True, "int8"])
def test_resnet_cifar_fused_bn_forward(fused):
    def build(P):
        return P.models.resnet.resnet_cifar10(_image(P, 3 * 32 * 32),
                                              depth=8, width=8,
                                              fused_bn=fused)
    net = Net(build, init="numpy")
    x = np.random.RandomState(2).randn(2, 3 * 32 * 32).astype(np.float32)
    net.check(*both_values({"image": x}), atol=TOL, is_training=True)


def test_vgg_tiny_forward():
    def build(P):
        return P.models.vgg.vgg(_image(P, 3 * 32 * 32), depth=11,
                                class_num=10)
    net = Net(build, init="numpy")
    x = np.random.RandomState(3).randn(2, 3 * 32 * 32).astype(np.float32)
    j, t = net.check(*both_values({"image": x}), atol=TOL)
    assert t[0]["v_out"].array.shape == (2, 10)


def _words(P, vocab=100):
    return P.layer.data("words", P.data_type.integer_value_sequence(vocab))


def _seq_rows(n, vocab=100, seed=0):
    rng = np.random.RandomState(seed)
    return [([int(w) for w in rng.randint(0, vocab, rng.randint(3, 10))],)
            for _ in range(n)]


@pytest.mark.parametrize("which", ["lstm", "conv", "tagger"])
def test_text_models_forward(which):
    def build(P):
        # sequence_conv_pool names its fc automatically: start both
        # packages' per-process counters alike
        P.topology._name_counters.pop("fc", None)
        w = _words(P)
        if which == "lstm":
            return P.models.text.lstm_text_classification(
                w, hidden_dim=16, emb_dim=8, stacked_num=2)
        if which == "conv":
            return P.models.text.text_conv_net(w, hidden_dim=12, emb_dim=8)
        return P.models.text.stacked_lstm_tagger(w, tag_num=5, emb_dim=8,
                                                 hidden_dim=8, depth=2)
    net = Net(build, seed=4)
    net.check_rows(_seq_rows(4), atol=TOL, grad=True)


def test_tagger_builds():
    out = T.models.text.stacked_lstm_tagger(_words(T, 50), tag_num=5,
                                            emb_dim=8, hidden_dim=8, depth=2)
    assert out.size == 5


def _cost_pair(builder, seed=1, opt=None):
    jc, tc = builder(J), builder(T)
    jp = J.parameters.create(jc, JKeySource(seed))
    tp = carry(jp, T.topology.Topology(tc))
    make = opt or (lambda P: P.optimizer.Momentum(momentum=0.9,
                                                  learning_rate=0.01))
    return (J.trainer.SGD(jc, jp, make(J)), T.trainer.SGD(tc, tp, make(T)))


def _train_pair(jt, tt, data, batch, passes=1):
    out = []
    for P, tr in ((J, jt), (T, tt)):
        costs = []
        P.init(seed=8)
        tr.train(P.batch(lambda: iter(data), batch), num_passes=passes,
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, P.event.EndIteration) else None)
        out.append(costs)
    return out


def test_smallnet_train_step(rng):
    def build(P):
        img = _image(P, 3 * 32 * 32)
        lbl = P.layer.data("label", P.data_type.integer_value(10))
        out = P.models.smallnet.smallnet(img)
        return P.layer.classification_cost(out, lbl, name="cost")
    jt, tt = _cost_pair(build)
    data = [(rng.randn(3 * 32 * 32).astype(np.float32), int(i % 10))
            for i in range(32)]
    jc, tc = _train_pair(jt, tt, data, 16)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)
    for k, v in jt.parameters.values.items():
        assert np.abs(tt.parameters[k] - np.asarray(v)).max() <= TOL, k


def test_lstm_text_model_train(rng):
    def build(P):
        out = P.models.text.lstm_text_classification(_words(P), hidden_dim=16,
                                                     emb_dim=8)
        lbl = P.layer.data("label", P.data_type.integer_value(2))
        return P.layer.classification_cost(out, lbl, name="cost")
    jt, tt = _cost_pair(build, seed=2,
                        opt=lambda P: P.optimizer.Adam(learning_rate=1e-3))
    data = [([int(w) for w in rng.randint(0, 100, rng.randint(3, 10))],
             int(i % 2)) for i in range(16)]
    jc, tc = _train_pair(jt, tt, data, 8)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)


class TestResnetModes:
    @pytest.mark.parametrize("mode", ["q8", "defer", "q8sr"])
    def test_deferral_modes_raise_a9(self, mode):
        """The deferral recipes (ported since the q8 pipeline): ResNet-50
        in each mode has the JAX package's parameter and state specs (53
        conv/BN pairs, every stash site's ``q_mean`` / ``q_scale``), and
        a CIFAR ResNet-8 at width 8 trains one step in both packages
        from the same parameters (q8sr from the same dropout key, so the
        same stochastic draws): every stash's codes equal but for counted
        one-step flips after a convolution (``tests/torch_q8_util.py``),
        then the cost, the new state and every gradient within 1e-4 of
        max(1, max|JAX value|)."""
        from tests.torch_q8_util import Q8Net
        tt = _same_specs(
            J.models.resnet.resnet_imagenet(_image(J, 3 * 224 * 224),
                                            fused_bn=mode),
            T.models.resnet.resnet_imagenet(_image(T, 3 * 224 * 224),
                                            fused_bn=mode))
        q8 = sum(1 for l in tt.layers if l.layer_type == "img_conv_bn_q8")
        assert q8 == 52, q8             # the stem stays dense
        assert 24e6 < _n_params(tt) < 27e6

        def build(P):
            img = _image(P, 3 * 32 * 32)
            lbl = P.layer.data("label", P.data_type.integer_value(10))
            out = P.models.resnet.resnet_cifar10(img, depth=8,
                                                 fused_bn=mode, width=8)
            return P.layer.classification_cost(out, lbl, name="cost")

        net = Q8Net(build, seed=3)
        rng = np.random.RandomState(0)
        jf, tf = both_values({
            "image": rng.rand(4, 3 * 32 * 32).astype(np.float32),
            "label": rng.randint(0, 10, 4).astype(np.int32)})
        net.check(jf, tf, is_training=True, grad=True, key=7, atol=TOL,
                  gatol=TOL)
        # every stash site read: the entry, 3 blocks' a/b (+2 projections)
        # and their adds
        assert len(net.flips) == 12, net.flips

    def test_full_mode_refused(self):
        with pytest.raises(ValueError, match="full"):
            T.models.resnet.conv_bn_layer(_image(T, 3 * 8 * 8), 4, 3, 1, 1,
                                          None, ch_in=3, fused="full")


# ---------------------------------------------------------------------------
# seq2seq (tests/test_seq2seq.py)

V, E, H = 10, 8, 12
BOS, EOS = 0, 1


def _s2s_batch(rng, B, T_):
    src = rng.randint(2, V, (B, T_)).astype(np.int32)
    lens = rng.randint(2, T_ + 1, B).astype(np.int32)
    trg = np.concatenate([np.full((B, 1), BOS, np.int32), src[:, :-1]], 1)
    nxt = src.copy()
    for b in range(B):
        nxt[b, lens[b] - 1] = EOS
    return src, lens, trg, nxt


def test_seq2seq_structure():
    """Both graphs' specs equal JAX's."""
    jc = J.models.seq2seq.seq2seq_train(V, V, word_vec_dim=E,
                                        encoder_size=H, decoder_size=H)
    tc = T.models.seq2seq.seq2seq_train(V, V, word_vec_dim=E,
                                        encoder_size=H, decoder_size=H)
    _same_specs(jc, tc)
    kw = dict(word_vec_dim=E, encoder_size=H, decoder_size=H, beam_size=3,
              max_length=6, bos_id=BOS, eos_id=EOS)
    _same_specs(J.models.seq2seq.seq2seq_generate(V, V, **kw),
                T.models.seq2seq.seq2seq_generate(V, V, **kw))


def test_seq2seq_first_step_matches():
    """The teacher-forced loss and its gradients match on one batch."""
    src, lens, trg, nxt = _s2s_batch(np.random.RandomState(0), 4, 5)
    net = Net(lambda P: P.models.seq2seq.seq2seq_train(
        V, V, word_vec_dim=E, encoder_size=H, decoder_size=H), seed=0,
              init="numpy")
    jf, tf = both_values({"source_language_word": (src, lens),
                          "target_language_word": (trg, lens),
                          "target_language_next_word": (nxt, lens)})
    net.check(jf, tf, atol=TOL, grad=True)


def test_seq2seq_copy_task_learns_and_generates():
    """The reference's copy task on the port alone: plain SGD over
    autograd for 60 steps, the same convergence invariants, then beam
    search sharing the learned parameters by name."""
    from paddle_tpu_torch.topology import Value
    from paddle_tpu_torch.utils.rng import KeySource
    cost = T.models.seq2seq.seq2seq_train(V, V, word_vec_dim=E,
                                          encoder_size=H, decoder_size=H)
    topo = T.topology.Topology(cost)
    params = T.parameters.create(cost, KeySource(0), device="cpu")
    fwd = topo.compile()
    rng = np.random.RandomState(0)
    vals = {k: v.clone() for k, v in params.values.items()}
    losses = []
    for _ in range(60):
        src, lens, trg, nxt = (torch.from_numpy(a) for a in
                               _s2s_batch(rng, 8, 5))
        leaves = {k: v.detach().requires_grad_() for k, v in vals.items()}
        outs, _ = fwd(leaves, params.state,
                      {"source_language_word": Value(src, lens),
                       "target_language_word": Value(trg, lens),
                       "target_language_next_word": Value(nxt, lens)})
        loss = torch.mean(outs["seq2seq_cost"].array
                          / torch.clamp_min(lens.float(), 1))
        g = torch.autograd.grad(loss, list(leaves.values()))
        vals = {k: (v - 0.5 * gk).detach() for (k, v), gk in
                zip(leaves.items(), g)}
        losses.append(float(loss.detach()))
    w = 10
    early, late = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    achieved = early - min(losses)
    assert late < early and achieved > 0, losses
    assert late < early - 0.5 * achieved, (early, late, achieved)
    smooth = np.convolve(losses, np.ones(w) / w, mode="valid")
    crossed = np.flatnonzero(smooth < early - 0.5 * achieved)
    assert crossed.size and smooth[crossed[0]:].max() < early, losses

    gen = T.models.seq2seq.seq2seq_generate(V, V, word_vec_dim=E,
                                            encoder_size=H, decoder_size=H,
                                            beam_size=3, max_length=6,
                                            bos_id=BOS, eos_id=EOS)
    gtopo = T.topology.Topology(gen)
    gparams = T.parameters.create(gen, KeySource(0), device="cpu")
    assert set(gparams.values) <= set(vals)
    src, lens, *_ = _s2s_batch(rng, 4, 5)
    with torch.no_grad():
        outs, _ = gtopo.compile()({k: vals[k] for k in gparams.values},
                                  gparams.state,
                                  {"source_language_word": Value(
                                      torch.from_numpy(src),
                                      torch.from_numpy(lens))})
    v = outs["generated_word"]
    assert tuple(v.array.shape) == (4, 3, 6)
    scores = v.weights.numpy()
    assert np.all(np.diff(scores, axis=1) <= 1e-6)     # beams sorted
    assert np.all(np.isfinite(scores[:, 0]))


# ---------------------------------------------------------------------------
# CTR wide&deep (tests/test_ctr.py)

WIDE, VOCAB = 1024, 256


class TestCtrWideDeep:
    def _pair(self, seed=5):
        jo, jc = J.models.ctr.ctr_wide_deep(WIDE, VOCAB, emb_dim=16,
                                            hidden=(32, 16))
        to, tc = T.models.ctr.ctr_wide_deep(WIDE, VOCAB, emb_dim=16,
                                            hidden=(32, 16))
        _same_specs(jc, tc)
        jp = J.parameters.create(jc, JKeySource(seed))
        tp = carry(jp, T.topology.Topology(tc))
        return (J.trainer.SGD(jc, jp, J.optimizer.Adam(learning_rate=1e-2)),
                T.trainer.SGD(tc, tp, T.optimizer.Adam(learning_rate=1e-2)))

    def test_learns_single_device_and_matches_jax(self):
        jt, tt = self._pair()
        rows = list(T.models.ctr.synthetic_reader(WIDE, VOCAB, n=256)())
        assert rows == list(J.models.ctr.synthetic_reader(WIDE, VOCAB,
                                                          n=256)())
        jc, tc = _train_pair(jt, tt, rows, 32, passes=3)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)
        assert tc[-1] < tc[0] * 0.8, (tc[0], tc[-1])

    def test_sparse_grad_only_touches_seen_rows(self):
        """Row-sparse gradient semantics: untouched embedding rows get a
        zero gradient (the scatter-add in the gather's backward)."""
        from paddle_tpu_torch.utils.rng import KeySource
        out, cost = T.models.ctr.ctr_wide_deep(WIDE, VOCAB, emb_dim=8,
                                               hidden=(8,))
        topo = T.topology.Topology(cost)
        params = T.parameters.create(cost, KeySource(1), device="cpu")
        feeder = T.data_feeder.DataFeeder(
            {l.name: l.data_spec for l in topo.data_layers}, device="cpu")
        feeds = feeder.feed([([1, 5], [3, 4, 5], 1), ([2, 7], [3, 9], 0)])
        leaves = {k: v.clone().requires_grad_()
                  for k, v in params.values.items()}
        outs, _ = topo.compile()(leaves, params.state, feeds)
        outs[cost.name].array.float().mean().backward()
        emb_g = leaves["ctr_emb.w"].grad.numpy()
        seen = sorted({3, 4, 5, 9})
        unseen = [i for i in range(VOCAB) if i not in seen]
        assert np.abs(emb_g[seen]).sum() > 0
        np.testing.assert_array_equal(emb_g[unseen], 0.0)

    def test_dist_rules_raise_a10(self):
        """Ported (the name is kept): the port's rules are the JAX
        package's, pattern for pattern and spec for spec (the sharded
        training is ``tests/test_torch_spmd.py::
        test_ctr_sharded_matches_single_device``)."""
        import paddle_tpu as J
        got = T.models.ctr.ctr_dist_rules("ctr")
        want = J.models.ctr.ctr_dist_rules("ctr")
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]

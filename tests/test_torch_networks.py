"""The port's composite networks against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_network_compare.py`` (mixed with a full-matrix
projection against fc, concatenated dotmuls against their elementwise
form, the bidirectional-LSTM composite against its manual construction)
and the network composites of ``tests/test_layers_extended.py``
(``img_conv_group`` / ``small_vgg``, ``vgg_16_network``,
``bidirectional_gru``, ``dot_product_attention``), each held against the
JAX package too; plus the graphs ``chip_smoke.py`` drives at full width,
here at small widths: the LSTM text classifier (``simple_lstm``, max
pooling, softmax, ``classification_cost``) and the attention seq2seq of
``models/seq2seq.py`` (two ``simple_gru`` encoders, a ``recurrent_group``
over ``gru_decoder_with_attention``, and the ``beam_search`` generator
sharing its parameters); ``sequence_conv_pool``, ``img_conv_bn_pool``,
``simple_gru2``; and one network at bf16 compute.

Tolerances: fp32 forward 1e-5, gradients through scans, BN and the
recurrent groups 1e-4 (of max(1, max|JAX value|)); bf16 within 2 bf16
ulps of max(|JAX value|, 2^-6); beam tokens and lengths exact.
"""

import numpy as np
import torch

import paddle_tpu_torch as T
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS
from tests.torch_layers_util import Net, both_values
from tests.torch_ops_util import bf16_ulp_err

torch.set_num_threads(1)


def _attr(P, name):
    return P.attr.ParamAttr(name=name)


class TestMixedVsFc:
    def test_full_matrix_projection_equals_fc(self, rng):
        def b(P):
            L = P.layer
            inp = L.data("x", P.data_type.dense_vector(6))
            a = L.mixed(size=5, input=[P.projection.full_matrix_projection(
                inp, 5, param_attr=_attr(P, "shared.w"))], act=None,
                bias_attr=False, name="via_mixed")
            c = L.fc(inp, 5, act=None, bias_attr=False, name="via_fc",
                     param_attr=_attr(P, "shared.w"))
            return [a, c]
        j, t = Net(b, seed=3).check(*both_values(
            {"x": rng.randn(4, 6).astype(np.float32)}), grad=True)
        np.testing.assert_allclose(t[0]["via_mixed"].array.detach().numpy(),
                                   t[0]["via_fc"].array.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


class TestConcatDotmul:
    def test_concat_of_dotmuls_equals_elementwise_form(self, rng):
        def b(P):
            L, Pr = P.layer, P.projection
            da = L.data("a", P.data_type.dense_vector(4))
            db = L.data("b", P.data_type.dense_vector(4))
            m1 = L.mixed(size=4, input=[Pr.dotmul_projection(
                da, param_attr=_attr(P, "dm.a"))], bias_attr=False,
                name="dm1")
            m2 = L.mixed(size=4, input=[Pr.dotmul_projection(
                db, param_attr=_attr(P, "dm.b"))], bias_attr=False,
                name="dm2")
            return L.concat([m1, m2], name="cat_a")
        xa, xb = (rng.randn(3, 4).astype(np.float32) for _ in range(2))
        net = Net(b, seed=7)
        j, t = net.check(*both_values({"a": xa, "b": xb}), grad=True)
        wa, wb = net.tparams["dm.a"], net.tparams["dm.b"]
        np.testing.assert_allclose(t[0]["cat_a"].array.detach().numpy(),
                                   np.concatenate([xa * wa, xb * wb], 1),
                                   rtol=1e-5, atol=1e-6)


class TestBidirectionalLstm:
    def test_composite_equals_manual_construction(self, rng):
        def b(P):
            L, N = P.layer, P.networks
            seq = L.data("seq", P.data_type.dense_vector_sequence(3))
            comp = N.bidirectional_lstm(seq, 4, name="bi", return_seq=True)
            return [comp, N.bidirectional_lstm(seq, 4, name="bi_last")]
        net = Net(b, seed=11)
        x = rng.randn(2, 5, 3).astype(np.float32)
        j, t = net.check(*both_values({"seq": (x, [5, 3])}), grad=True)
        # the manual construction with the composite's parameters
        L, N = T.layer, T.networks
        seq = L.data("seq", T.data_type.dense_vector_sequence(3))
        f = N.simple_lstm(seq, 4, name="bi_fw")
        r = N.simple_lstm(seq, 4, reverse=True, name="bi_bw")
        manual = T.topology.Topology(L.concat([f, r], name="bi_manual"))
        assert {s.name for s in manual.param_specs()} <= set(net.tparams.values)
        o, _ = manual.compile()(net.tparams.values, {},
                                both_values({"seq": (x, [5, 3])})[1])
        np.testing.assert_allclose(o["bi_manual"].array.numpy(),
                                   t[0]["bi"].array.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


class TestNetworkComposites:
    def test_img_conv_group_and_small_vgg_shapes(self, rng):
        def b(P):
            img = P.layer.data("ncg_im", P.data_type.dense_vector(768))
            return P.networks.small_vgg(img, num_channels=3, num_classes=10)
        j, t = Net(b, init="numpy").check(*both_values(
            {"ncg_im": rng.randn(2, 768).astype(np.float32)}))
        o = t[0]["svgg_out"].array.numpy()
        assert o.shape == (2, 10)
        np.testing.assert_allclose(o.sum(-1), 1.0, rtol=1e-4)

    def test_vgg16_builds(self, rng):
        """The 16 layers' parameter specs agree in name, order and shape;
        the forward agrees on shared weights (numpy draws: 34M values)."""
        def b(P):
            img = P.layer.data("v16_im", P.data_type.dense_vector(3072))
            return P.networks.vgg_16_network(img, num_channels=3,
                                             num_classes=7)
        net = Net(b, init="numpy")
        j, t = net.check(*both_values(
            {"v16_im": rng.randn(1, 3072).astype(np.float32)}))
        assert tuple(t[0]["vgg16_out"].array.shape) == (1, 7)

    def test_bidirectional_gru(self, rng):
        def b(P):
            seq = P.layer.data("bg_in", P.data_type.dense_vector_sequence(6))
            return [P.networks.bidirectional_gru(seq, size=5, name="bg"),
                    P.networks.bidirectional_gru(seq, size=3, name="bgs",
                                                 return_seq=True)]
        j, t = Net(b).check(*both_values({"bg_in": (
            rng.randn(2, 4, 6).astype(np.float32), [4, 2])}), grad=True)
        assert tuple(t[0]["bg_concat"].array.shape) == (2, 10)

    def test_dot_product_attention_weights_sum_to_one(self, rng):
        def b(P):
            enc = P.layer.data("dpa_enc",
                               P.data_type.dense_vector_sequence(4))
            st = P.layer.data("dpa_st", P.data_type.dense_vector(4))
            return P.networks.dot_product_attention(enc, enc, st, name="dpa")
        x = rng.randn(2, 5, 4).astype(np.float32)
        j, t = Net(b).check(*both_values({
            "dpa_enc": (x, [5, 3]),
            "dpa_st": rng.randn(2, 4).astype(np.float32)}))
        o = t[0]["dpa"].array.numpy()
        for bi, n in enumerate([5, 3]):
            assert (o[bi] >= x[bi, :n].min(0) - 1e-5).all()
            assert (o[bi] <= x[bi, :n].max(0) + 1e-5).all()


def lstm_classifier(P, vocab=50, emb=8, hidden=6):
    """The LSTM text classifier of ``benchmarks/configs/lstm.py``
    (``models/text.lstm_text_classification``), named layers."""
    L, dt = P.layer, P.data_type
    words = L.data("words", dt.integer_value_sequence(vocab))
    e = L.embedding(words, emb, name="t_emb")
    h = P.networks.simple_lstm(e, hidden, name="t_lstm0")
    pooled = L.pool(h, pooling_type=P.pooling.Max(), name="t_pool")
    out = L.fc(pooled, 2, act=P.activation.Softmax(), name="t_out")
    return L.classification_cost(out, L.data("label", dt.integer_value(2)),
                                  name="cost")


def seq2seq(P, V=30, E=8, H=6, generate=False, beam=3, max_len=6):
    """``models/seq2seq.py``'s graphs, named layers; one parameter set."""
    L, N, dt = P.layer, P.networks, P.data_type
    src = L.data("source_language_word", dt.integer_value_sequence(V))
    se = L.embedding(src, E, param_attr=_attr(P, "_source_language_embedding"),
                     name="src_emb")
    fwd = N.simple_gru(se, H, name="src_fwd_gru")
    bwd = N.simple_gru(se, H, reverse=True, name="src_bwd_gru")
    enc = L.concat([fwd, bwd], name="encoded_vector")
    proj = L.fc(enc, H, act="linear", bias_attr=False, name="encoded_proj",
                param_attr=_attr(P, "_encoded_proj.w"))
    boot = L.fc(L.first_seq(bwd, name="enc_last"), H, act="tanh",
                name="decoder_boot", param_attr=_attr(P, "_decoder_boot.w"))

    def step(e, p, w):
        g = N.gru_decoder_with_attention(e, p, w, H, boot, name="decoder_gru")
        return L.fc(g, V, act="softmax", name="decoder_out",
                    param_attr=_attr(P, "_decoder_out.w"))
    statics = [L.StaticInput(enc, is_seq=True),
               L.StaticInput(proj, is_seq=True)]
    if generate:
        return L.beam_search(step, input=statics + [L.GeneratedInput(
            size=V, embedding_name="_target_language_embedding",
            embedding_size=E)], bos_id=0, eos_id=1, beam_size=beam,
            max_length=max_len, name="generated_word")
    trg = L.data("target_language_word", dt.integer_value_sequence(V))
    te = L.embedding(trg, E, param_attr=_attr(P, "_target_language_embedding"),
                     name="trg_emb")
    dec = L.recurrent_group(step, input=statics + [te], name="decoder_group")
    lbl = L.data("target_language_next_word", dt.integer_value_sequence(V))
    return L.classification_cost(dec, lbl, name="seq2seq_cost")


class TestBenchmarkGraphs:
    def test_lstm_classifier_trains_like_jax(self, rng):
        net = Net(lstm_classifier, seed=1)
        rows = [(list(rng.randint(0, 50, n)), int(rng.randint(2)))
                for n in (7, 12, 3, 9)]
        net.check_rows(rows, grad=True, is_training=True)

    @staticmethod
    def _s2s_rows(rng):
        rows = []
        for n, m in ((5, 4), (8, 6), (3, 7)):
            trg = list(rng.randint(2, 30, m))
            rows.append((list(rng.randint(2, 30, n)), [0] + trg[:-1], trg))
        return rows

    def test_seq2seq_train(self, rng):
        Net(seq2seq, init="numpy").check_rows(self._s2s_rows(rng), grad=True,
                                              is_training=True)

    def test_seq2seq_generate(self, rng):
        """The generator on the training graph's parameters: tokens,
        lengths and scores equal to JAX's."""
        gen = Net(lambda P: seq2seq(P, generate=True), init="numpy")
        j, t = gen.check_rows([(r[0],) for r in self._s2s_rows(rng)])
        v = t[0]["generated_word"]
        assert tuple(v.array.shape) == (3, 3, 6)


class TestMoreComposites:
    def test_sequence_conv_pool_gru2_conv_bn_pool(self, rng):
        def b(P):
            L, N, dt = P.layer, P.networks, P.data_type
            seq = L.data("s", dt.dense_vector_sequence(4))
            img = L.data("im", dt.dense_vector(2 * 8 * 8))
            return [N.sequence_conv_pool(seq, context_len=3, hidden_size=5,
                                         fc_name="scp_fc", name="scp"),
                    L.last_seq(N.simple_gru2(seq, 3, name="g2"),
                               name="g2_last"),
                    N.img_conv_bn_pool(img, filter_size=3, num_filters=4,
                                       pool_size=2, num_channel=2,
                                       act=P.activation.Relu(),
                                       name="cbp")]
        Net(b).check(*both_values({
            "s": (rng.randn(3, 5, 4).astype(np.float32), [5, 2, 4]),
            "im": rng.randn(3, 128).astype(np.float32)}), grad=True,
            is_training=True)


def test_bf16_network(rng):
    """conv → BN → pool → fc → softmax at bf16 compute: every output
    within 2 bf16 ulps of the JAX package's."""
    def b(P):
        L = P.layer
        img = L.data("im", P.data_type.dense_vector(3 * 8 * 8))
        c = L.img_conv(img, 3, num_filters=8, num_channels=3, act="relu",
                       name="bc1")
        c = L.batch_norm(c, act="relu", name="bbn")
        c = L.img_pool(c, 2, name="bp")
        h = L.fc(c, 16, act="tanh", name="bf1")
        return [c, h, L.fc(h, 5, act="softmax", name="bout")]
    old_j, old_t = JFLAGS.get("compute_dtype"), TFLAGS.get("compute_dtype")
    JFLAGS.set("compute_dtype", "bfloat16")
    TFLAGS.set("compute_dtype", "bfloat16")
    try:
        net = Net(b)
        j, t = net.run(*both_values(
            {"im": rng.randn(2, 192).astype(np.float32)}),
            is_training=True)
    finally:
        JFLAGS.set("compute_dtype", old_j)
        TFLAGS.set("compute_dtype", old_t)
    for n in j[0]:
        assert t[0][n].array.dtype == getattr(torch, str(
            j[0][n].array.dtype)), n
        err = bf16_ulp_err(t[0][n].array.detach(), j[0][n].array)
        assert err <= 2, f"{n}: {err} bf16 ulps"
    for n in j[1]:
        assert bf16_ulp_err(t[1][n], j[1][n]) <= 2, n

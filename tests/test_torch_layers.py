"""The port's layer API core against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_layers.py`` (fc, multi-input and sparse fc,
the conv/pool stack, batch-norm state, dropout, the embedding + LSTM
sequence, the costs, cos_sim, gradients through the compiled topology,
duplicate names, the feeder's range checks and sparse sequences,
``Topology.find``, sparse sequence pooling and its training), each built
in both packages by one builder and held against the JAX package, plus
the foundations the layer API stands on: ``prng.fold_in`` keys and bits,
``KeySource``, ``parameters.create`` (key equality, constants exactly,
the other initialisers by their bounds and moments), ``check_numerics``,
``Parameters.to_tar`` files loading across both packages bit for bit,
auto-named graphs built after unrelated JAX builds, the package's lazy
names, and the entry points refusing to fall back to the CPU.

Tolerances: fp32 forward 1e-5, gradients 1e-4 (of max(1, max|JAX
value|)); ids, masks, lengths, keys and tar bytes exact.
"""

import io
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.utils.rng import KeySource as JKS
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.utils import enforce as tenforce
from paddle_tpu_torch.utils.rng import KeySource as TKS
from tests.torch_layers_util import Net, both_values, carry

torch.set_num_threads(1)


def _dense_rows(rng, n, *dims):
    return [tuple(rng.randn(d).astype(np.float32) for d in dims)
            for _ in range(n)]


def test_fc_graph(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(8))
        return P.layer.fc(x, 4, act=P.activation.Relu(), name="fc1")
    net = Net(b)
    assert net.tparams.get_shape("fc1.w") == (8, 4)
    assert net.tparams.get_shape("fc1.b") == (4,)
    net.check_rows(_dense_rows(rng, 3, 8), grad=True)


def test_fc_multi_input_sum(rng):
    def b(P):
        a = P.layer.data("a", P.data_type.dense_vector(4))
        c = P.layer.data("b", P.data_type.dense_vector(6))
        return P.layer.fc([a, c], 3, name="m", bias_attr=False)
    net = Net(b)
    assert set(net.tparams.names()) == {"m.w0", "m.w1"}
    net.check_rows(_dense_rows(rng, 2, 4, 6), grad=True)


def test_fc_sparse_input(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.sparse_binary_vector(50))
        return P.layer.fc(x, 4, name="s", bias_attr=False)
    net = Net(b)
    net.check_rows([([3, 7, 11],), ([0],)], grad=True)


def test_conv_pool_stack(rng):
    def b(P):
        img = P.layer.data("img", P.data_type.dense_vector(144))
        cp = P.networks.simple_img_conv_pool(
            img, filter_size=5, num_filters=4, pool_size=2, num_channel=1,
            act=P.activation.Relu(), name="cp")
        return P.layer.fc(cp, 10, act=P.activation.Softmax(), name="out")
    net = Net(b)
    j, t = net.check_rows(_dense_rows(rng, 2, 144), grad=True)
    np.testing.assert_allclose(t[0]["out"].array.detach().sum(-1).numpy(),
                               1.0, rtol=1e-5)


def test_batch_norm_state_threading(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(6))
        return P.layer.batch_norm(P.layer.fc(x, 6, name="f"), name="bn")
    net = Net(b)
    rows = [(r[0] * 3 + 2,) for r in _dense_rows(rng, 16, 6)]
    j, t = net.check_rows(rows, is_training=True, grad=True)
    assert float(t[1]["bn.mean"].abs().sum()) > 0
    # the running statistics come back as new tensors
    assert t[1]["bn.mean"] is not net.tparams.state["bn.mean"]
    j, t = net.check_rows(rows, is_training=False)
    np.testing.assert_array_equal(t[1]["bn.mean"].numpy(),
                                  net.tparams.state["bn.mean"].numpy())


def test_dropout_train_vs_infer(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(100))
        return P.layer.dropout(x, 0.5, name="drop")
    net = Net(b)
    rows = [(np.ones(100, np.float32),)] * 4
    for key in (0, 7, 123):
        j, t = net.check_rows(rows, is_training=True, key=key, atol=0.0)
        dropped = t[0]["drop"].array.numpy()
        np.testing.assert_array_equal(dropped == 0,
                                      np.asarray(j[0]["drop"].array) == 0)
        assert 0.2 < (dropped == 0).mean() < 0.8
        assert set(np.round(np.unique(dropped), 4)) <= {0.0, 2.0}
    j, t = net.check_rows(rows, is_training=False)
    np.testing.assert_array_equal(t[0]["drop"].array.numpy(), rows[0][0][None]
                                  .repeat(4, 0))


def test_embedding_sequence_lstm(rng):
    def b(P):
        words = P.layer.data("words", P.data_type.integer_value_sequence(30))
        emb = P.layer.embedding(words, 8, name="emb")
        lstm = P.networks.simple_lstm(emb, 6, name="lstm")
        return P.layer.last_seq(lstm, name="last")
    net = Net(b)
    j, t = net.check_rows([([1, 2, 3],), ([4, 5, 6, 7, 8],)], grad=True)
    assert tuple(t[0]["last"].array.shape) == (2, 6)


def test_cost_layers(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(5))
        lbl = P.layer.data("lbl", P.data_type.integer_value(3))
        sm = P.layer.fc(x, 3, act=P.activation.Softmax(), name="sm")
        return P.layer.classification_cost(sm, lbl, name="cost")
    net = Net(b)
    rows = [(r[0], l) for r, l in zip(_dense_rows(rng, 4, 5), [0, 1, 2, 0])]
    j, t = net.check_rows(rows, grad=True)
    assert tuple(t[0]["cost"].array.shape) == (4,)


def test_cos_sim_and_misc(rng):
    def b(P):
        a = P.layer.data("a", P.data_type.dense_vector(4))
        c = P.layer.data("b", P.data_type.dense_vector(4))
        return P.layer.cos_sim(a, c, name="cs")
    net = Net(b)
    net.check_rows(_dense_rows(rng, 3, 4, 4))


def test_topology_grad(rng):
    """Gradients of the compiled forward through ``torch.autograd`` over a
    parameter dict of leaf tensors (the JAX package's ``jax.grad``)."""
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(8))
        lbl = P.layer.data("lbl", P.data_type.integer_value(4))
        out = P.layer.fc(x, 4, name="w")
        return P.layer.classification_cost(out, lbl, name="cost")
    net = Net(b)
    rows = [(r[0], int(l)) for r, l in
            zip(_dense_rows(rng, 6, 8), rng.randint(0, 4, 6))]
    j, t = net.check_rows(rows, grad=True)
    assert float(t[2]["w.w"].abs().sum()) > 0


def test_duplicate_names_rejected():
    L, dt = T.layer, T.data_type
    x = L.data("x", dt.dense_vector(4))
    a = L.fc(x, 2, name="same")
    with pytest.raises(tenforce.EnforceError, match="duplicate"):
        T.topology.Topology(L.fc(a, 2, name="same"))


def test_feeder_rejects_out_of_range_indices():
    F = T.data_feeder.DataFeeder
    dt = T.data_type
    feeder = F({"label": dt.integer_value(10)}, device="cpu")
    with pytest.raises(ValueError, match="label.*10"):
        feeder.feed([(10,), (3,)])
    with pytest.raises(ValueError, match="label"):
        feeder.feed([(-1,)])
    seq_feeder = F({"words": dt.integer_value_sequence(30)}, device="cpu")
    with pytest.raises(ValueError, match="words.*30"):
        seq_feeder.feed([([1, 2, 30],)])
    assert tuple(feeder.feed([(9,), (0,)])["label"].array.shape) == (2,)


def test_topology_find_addresses_any_layer():
    L, dt = T.layer, T.data_type
    x = L.data("tf_x", dt.dense_vector(4))
    h = L.fc(x, 8, name="tf_hidden")
    topo = T.topology.Topology(L.fc(h, 2, name="tf_out"))
    assert topo.find("tf_hidden") is h
    with pytest.raises(KeyError, match="nope"):
        topo.find("nope")


@pytest.mark.parametrize("kind,rows", [
    ("sparse_binary_vector_sequence",
     [([[1, 3], [5]],), ([[7], [8, 9], [10, 11, 2]],)]),
    ("sparse_float_vector_sequence",
     [([[(4, 0.5)], [(6, 2.0), (7, -1.0)]],)]),
    ("sparse_binary_vector_sub_sequence", [([[[1], [2, 3]], [[4]]],)]),
    ("dense_vector_sub_sequence",
     [([np.ones((2, 3), np.float32), np.zeros((1, 3), np.float32)],)]),
    ("integer_value_sub_sequence", [([[1, 2], [3]],), ([[4]],)]),
])
def test_feeder_sequences_match(kind, rows):
    """The two feeders give the same ids, weights, lengths and
    sub-lengths (sparse sequences: [b, T, K] ids + weights)."""
    dim = 3 if kind.startswith("dense") else 40
    jt = {"x": getattr(J.data_type, kind)(dim)}
    tt = {"x": getattr(T.data_type, kind)(dim)}
    jv = J.data_feeder.DataFeeder(jt).feed(rows)["x"]
    tv = T.data_feeder.DataFeeder(tt, device="cpu").feed(rows)["x"]
    for f in ("array", "lengths", "sub_lengths", "weights"):
        a, b = getattr(tv, f), getattr(jv, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fc_sparse_sequence_pool(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.sparse_binary_vector_sequence(30))
        h = P.layer.fc(x, 5, name="sfc", bias_attr=False)
        return P.layer.pool(h, pooling_type=P.pooling.Sum(), name="pooled")
    net = Net(b)
    net.check_rows([([[2, 4], [9]],), ([[0], [1, 5], [6]],)], grad=True)


def test_sparse_sequence_trains_e2e():
    """quick_start-style sparse text classification: the port's Adam over
    the port's gradients follows the JAX package's first steps and
    reaches low loss."""
    def b(P):
        x = P.layer.data("x", P.data_type.sparse_binary_vector_sequence(12))
        h = P.layer.fc(x, 8, act=P.activation.Relu(), name="h")
        pooled = P.layer.pool(h, pooling_type=P.pooling.Sum(), name="p")
        sm = P.layer.fc(pooled, 2, act=P.activation.Softmax(), name="sm")
        lbl = P.layer.data("lbl", P.data_type.integer_value(2))
        return P.layer.classification_cost(sm, lbl, name="cost")
    net = Net(b)
    batch = [([[1, 2], [3]], 0), ([[7], [2]], 1), ([[4], [5, 0]], 0),
             ([[6, 11]], 1), ([[3, 2, 1]], 0), ([[9], [10], [1]], 1)]
    jf, tf = net.feeds(batch)
    jopt = J.optimizer.Adam(learning_rate=0.05)
    jp, jo = net.jparams.values, None
    jo = jopt.init_state(jp)
    topt = T.optimizer.Adam(learning_rate=0.05)
    tp = {k: v.clone() for k, v in net.tparams.values.items()}
    to = topt.init_state(tp)

    def jloss(p):
        o, _ = net.jfwd(p, {}, jf, is_training=True)
        return jnp.mean(o["cost"].array)

    jstep = jax.jit(jax.value_and_grad(jloss))
    jlosses, tlosses = [], []
    for i in range(30):
        l, g = jstep(jp)
        jp, jo = jopt.update(jnp.asarray(i, jnp.int32), g, jp, jo)
        jlosses.append(float(l))
        leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
        o, _ = net.tfwd(leaves, {}, tf, is_training=True)
        tl = o["cost"].array.mean()
        grads = dict(zip(leaves, torch.autograd.grad(tl, list(
            leaves.values()))))
        tp = {k: v.detach() for k, v in leaves.items()}
        tp, to = topt.update(i, grads, tp, to)
        tlosses.append(tl.detach().item())
    np.testing.assert_allclose(tlosses[:5], jlosses[:5], rtol=1e-4)
    assert tlosses[-1] < 0.1 < tlosses[0], tlosses


# ---------------------------------------------------------------------------
# the foundations: keys, parameter specs, numerics, the parameter file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_fold_in_and_key_source_match_jax(seed):
    ks_j, ks_t = JKS(seed), TKS(seed)
    for name in ("fc.w", "emb.w", "__fc_layer_0__.b"):
        jk = np.asarray(jax.random.key_data(ks_j.named(name)))
        np.testing.assert_array_equal(ks_t.named(name).numpy(),
                                      jk.astype(np.int64))
        jk = np.asarray(jax.random.key_data(ks_j.step(name, 17)))
        np.testing.assert_array_equal(ks_t.step(name, 17).numpy(),
                                      jk.astype(np.int64))
        np.testing.assert_array_equal(
            prng.random_bits(ks_t.named(name), (3, 5)).numpy(),
            np.asarray(jax.random.bits(ks_j.named(name), (3, 5)))
            .astype(np.int64))
    d = zlib.crc32(b"drop") & 0x7FFFFFFF
    np.testing.assert_array_equal(
        prng.fold_in(prng.prng_key(seed), d).numpy(),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), d))
        .astype(np.int64))


def test_seed_flag_drives_both_packages():
    from paddle_tpu.utils.flags import GLOBAL_FLAGS as JF
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TF
    assert TF.get("seed") == JF.get("seed")
    np.testing.assert_array_equal(
        TKS().named("w").numpy(),
        np.asarray(jax.random.key_data(JKS().named("w"))).astype(np.int64))


def test_parameters_create_draws_the_jax_stream():
    """Constants exactly; uniform/xavier within an ulp of JAX's and inside
    their bounds; normal/msra within XLA's erfinv polynomial, with the
    right moments."""
    def b(P):
        A = P.attr
        x = P.layer.data("x", P.data_type.dense_vector(64))
        h = P.layer.fc(x, 96, name="n")
        h = P.layer.fc(h, 96, name="u", param_attr=A.ParamAttr(
            initializer="uniform", initial_std=0.1))
        h = P.layer.fc(h, 96, name="xv", param_attr=A.ParamAttr(
            initializer="xavier"))
        h = P.layer.fc(h, 96, name="ms", param_attr=A.ParamAttr(
            initializer="msra"), bias_attr=A.ParamAttr(initial_value=0.5))
        return P.layer.batch_norm(h, name="bn")
    jt = J.topology.Topology(b(J))
    tt = T.topology.Topology(b(T))
    jp = J.parameters.create(jt, JKS(11))
    tp = T.parameters.create(tt, TKS(11), device="cpu")
    assert tp.device == torch.device("cpu")
    assert list(tp.values) == list(jp.values)
    for k in jp.values:
        got, want = tp.values[k].numpy(), np.asarray(jp.values[k])
        assert got.dtype == want.dtype and got.shape == want.shape
        if k.endswith(".b") or k.startswith("bn."):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k in ("u.w", "xv.w"):
            lim = 0.1 if k == "u.w" else np.sqrt(6.0 / 192)
            assert np.abs(got).max() <= lim
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 * lim)
        else:
            std = 1 / 8 if k == "n.w" else np.sqrt(2.0 / 96)
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
            assert abs(got.std() / std - 1) < 0.1 and abs(got.mean()) < 0.1 * std
    for k in jp.state:
        np.testing.assert_array_equal(tp.state[k].numpy(),
                                      np.asarray(jp.state[k]))


def test_check_numerics_walks_tensors():
    tenforce.check_numerics({"a": torch.ones(3), "b": [torch.arange(3)]})
    v = T.topology.Value(torch.tensor([1.0, float("nan")]))
    with pytest.raises(tenforce.EnforceError, match=r"\['x'\].array: 1 NaN"):
        tenforce.check_numerics({"x": v})
    with pytest.raises(tenforce.EnforceError, match="1 Inf"):
        tenforce.check_numerics([torch.tensor([float("inf")],
                                              dtype=torch.bfloat16)])


def test_parameter_files_cross_both_packages_bit_for_bit(rng):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(5))
        h = P.layer.fc(x, 7, name="h")
        return P.layer.batch_norm(h, name="bn")
    jt, tt = J.topology.Topology(b(J)), T.topology.Topology(b(T))
    jp = J.parameters.create(jt, JKS(3))
    jp.state["bn.mean"] = jnp.asarray(rng.randn(7).astype(np.float32))
    tp = carry(jp, tt)
    for k in jp.values:
        np.testing.assert_array_equal(tp.values[k].numpy(),
                                      np.asarray(jp.values[k]))
    tp["h.w"] = rng.randn(5, 7).astype(np.float32)
    buf = io.BytesIO()
    tp.to_tar(buf)
    raw = buf.getvalue()
    back = J.parameters.Parameters.from_tar(io.BytesIO(raw))
    for k in tp.values:
        np.testing.assert_array_equal(np.asarray(back.values[k]),
                                      tp.values[k].numpy())
    np.testing.assert_array_equal(np.asarray(back.state["bn.mean"]),
                                  np.asarray(jp.state["bn.mean"]))
    again = T.parameters.Parameters.from_tar(io.BytesIO(raw), device="cpu")
    assert set(again.values) == set(tp.values)
    fresh = io.BytesIO()
    again.to_tar(fresh)
    assert fresh.getvalue() == raw


def test_auto_named_graphs_after_unrelated_jax_builds(rng):
    """The packages count auto names apart: a graph built after extra JAX
    builds gets other names in each, so parameters pair by the order of
    ``param_specs()`` with equal shapes, never by name."""
    for _ in range(3):                       # unrelated JAX-only builds
        J.layer.fc(J.layer.data("u", J.data_type.dense_vector(2)), 2)

    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(6))
        h = P.layer.fc(x, 5, act=P.activation.Tanh())
        return P.layer.fc(h, 3, act=P.activation.Softmax())
    jo, to = b(J), b(T)
    jt, tt = J.topology.Topology(jo), T.topology.Topology(to)
    js, ts = jt.param_specs(), tt.param_specs()
    assert [s.shape for s in js] == [tuple(s.shape) for s in ts]
    assert [s.name for s in js] != [s.name for s in ts]
    jp = J.parameters.create(jt, JKS(1))
    tp = T.parameters.Parameters(ts, device="cpu")
    tp.values = {t.name: torch.from_numpy(np.array(jp.values[j.name]))
                 for j, t in zip(js, ts)}
    xs = rng.randn(4, 6).astype(np.float32)
    jout, _ = jt.compile()(jp.values, {}, {jt.data_layers[0].name: xs})
    tout, _ = tt.compile()(tp.values, {}, {tt.data_layers[0].name: xs})
    np.testing.assert_allclose(tout[to.name].array.numpy(),
                               np.asarray(jout[jo.name].array), atol=1e-6)


def test_lazy_names_and_pending_items():
    import sys
    assert "paddle_tpu_torch.layer" in sys.modules
    assert T.infer is T.inference.infer
    assert "layer" in dir(T)
    assert T._PENDING == {}
    assert T.distributed.__name__ == "paddle_tpu_torch.distributed"
    for name in ("dataset", "image", "plot", "version"):
        assert getattr(T, name).__name__ == f"paddle_tpu_torch.{name}"
        assert name in dir(T)
    assert T.dataset.mnist.train().provenance in ("real", "synthetic")
    assert T.pipeline.Pipeline is T.pipeline.core.Pipeline
    assert T.trainer.SGD and T.batch is T.reader.minibatch.batch
    assert not any(m.startswith("paddle_tpu_torch.ops.kernels.")
                   and m != "paddle_tpu_torch.ops.kernels._build"
                   for m in sys.modules if "layer" in m)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; the card is the default there")
def test_entry_points_default_to_the_card():
    dt = T.data_type
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.data_feeder.DataFeeder({"x": dt.dense_vector(2)})
    x = T.layer.data("x", dt.dense_vector(2))
    out = T.layer.fc(x, 2, name="dflt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.parameters.create(out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.parameters.Parameters.from_numpy({"dflt.w": np.zeros((2, 2))})


def test_printer_prints_the_jax_text(capsys):
    def b(P):
        x = P.layer.data("x", P.data_type.dense_vector(3))
        return P.layer.printer(x, name="pr", format="value {}")
    from tests.torch_layers_util import both_values
    net = Net(b)
    jf, tf = both_values({"x": np.array([[1.0, 2.5, -3.0]], np.float32)})
    net.jfwd(net.jparams.values, {}, jf)
    jax.effects_barrier()
    jtext = capsys.readouterr().out
    net.tfwd(net.tparams.values, {}, tf)
    assert capsys.readouterr().out == jtext
    assert jtext.startswith("pr: value [[")


def test_q8_layers_wait_for_a9():
    """The four q8 layers (ported with the q8 pipeline) keep the JAX
    package's signatures, build, and train one step as the JAX layers
    do: a dense stem, ``q8_entry``, a stride-2 ``img_conv_bn_q8``, an
    ``addto_q8`` of it with a 1x1 stride-2 projection and ``q8_exit``,
    held by ``tests/torch_q8_util.Q8Net`` (codes with counted flips, then
    the cost, the new state and every gradient within 1e-4).
    ``Topology``'s q8 build checks are the reference's."""
    import inspect
    from tests.torch_q8_util import Q8Net
    for name in ("q8_entry", "img_conv_bn_q8", "addto_q8", "q8_exit"):
        assert list(inspect.signature(getattr(T.layer, name)).parameters) \
            == list(inspect.signature(getattr(J.layer, name)).parameters)

    def build(P):
        L, act = P.layer, P.activation
        img = L.data("img", P.data_type.dense_vector(4 * 8 * 8))
        stem = L.img_conv(img, 3, 8, num_channels=4, padding=1,
                          act=act.Relu(), bias_attr=False, name="ql_stem",
                          img_size=8)
        ent = L.q8_entry(stem, name="ql_entry")
        c = L.img_conv_bn_q8(ent, 3, 8, stride=2, padding=1,
                             act=act.Relu(), name="ql_c")
        pr = L.img_conv_bn_q8(ent, 1, 8, stride=2, padding=0, name="ql_p")
        add = L.addto_q8([c, pr], act=act.Relu(), name="ql_add")
        return L.q8_exit(add, name="ql_exit")

    net = Q8Net(build, seed=2)
    x = np.random.RandomState(0).rand(4, 4 * 8 * 8).astype(np.float32)
    jf, tf = both_values({"img": x})
    net.check(jf, tf, is_training=True, grad=True, atol=1e-4, gatol=1e-4)
    assert set(net.flips) == {"ql_entry", "ql_c", "ql_p", "ql_add"}
    x = T.layer.data("x", T.data_type.dense_vector(4))
    prod = T.layer.fc(x, 4, name="q8_like")
    prod._q8 = (None, None, 1e-5)
    with pytest.raises(tenforce.EnforceError, match="graph output"):
        T.topology.Topology(prod)
    with pytest.raises(tenforce.EnforceError, match="not q8-aware"):
        T.topology.Topology(T.layer.fc(prod, 2, name="after_q8"))

"""The port's recurrent_group / memory / beam_search against
``paddle_tpu``'s on the CPU.

Every case of ``tests/test_recurrent_beam.py``: a recurrent_group step
against the fused recurrent layer, boot memories and static inputs, the
reversed group, gradients through the group (held here against
``jax.grad``), the beam-search op (greedy rollout, true log-probs, the
delayed-reward trap, state gathered by parent: tokens, lengths and
scores equal to JAX's), the beam_search generation layer, and the
cross-entropy over the beam (path enumeration, the valid mask, its
gradients, the flat-feed layer). Plus ``lstm_step`` memories and rows
past their length keeping their memory.

Tolerances: fp32 forward 1e-5; gradients through the groups and scans
1e-4 (of max(1, max|JAX value|)); tokens and lengths exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops import beam as jbeam
from paddle_tpu_torch.ops import beam as tbeam
from tests.torch_layers_util import Net, both_values
from tests.torch_ops_util import parity

torch.set_num_threads(1)


def _seq(P, name, dim):
    return P.layer.data(name, P.data_type.dense_vector_sequence(dim))


def _tie(net, dst, src):
    """Give parameter ``dst`` the value of ``src`` in both packages."""
    net.jparams.values[dst] = net.jparams.values[src]
    net.tparams.values[dst] = net.tparams.values[src].clone()


class TestRecurrentGroup:
    def test_matches_fused_recurrent_layer(self, rng):
        B, Tn, F, H = 3, 5, 4, 6

        def b(P):
            L = P.layer
            x = _seq(P, "x", F)

            def step(x_t):
                m = L.memory(name="rnn_h", size=H)
                return L.fc([x_t, m], size=H, act="tanh", name="rnn_h",
                            bias_attr=False)
            group = L.recurrent_group(step, input=x, name="grp")
            fused_in = L.fc(x, size=H, act="linear", name="proj",
                            bias_attr=False)
            return [group, L.recurrent(fused_in, act="tanh", name="fused")]
        net = Net(b, seed=0)
        _tie(net, "proj.w", "rnn_h.w0")
        _tie(net, "fused.w", "rnn_h.w1")
        lens = np.array([5, 3, 4], np.int32)
        j, t = net.check(*both_values({"x": (
            rng.randn(B, Tn, F).astype(np.float32), lens)}), grad=True)
        mask = np.arange(Tn)[None, :, None] < lens[:, None, None]
        a = t[0]["grp"].array.detach().numpy()
        f = t[0]["fused"].array.detach().numpy()
        np.testing.assert_allclose(np.where(mask, a, 0), np.where(mask, f, 0),
                                   rtol=1e-5, atol=1e-5)

    def test_memory_boot_and_static_input(self, rng):
        B, Tn, F, H = 2, 4, 3, 3

        def b(P):
            L = P.layer
            x, c = _seq(P, "x", F), P.layer.data(
                "c", P.data_type.dense_vector(H))

            def step(x_t, c_all):
                m = L.memory(name="acc", size=H, boot_layer=c)
                return L.addto([m, c_all], name="acc", act="linear",
                               bias_attr=False)
            return L.recurrent_group(step, input=[x, L.StaticInput(c)],
                                     name="g2")
        cs = rng.randn(B, H).astype(np.float32)
        j, t = Net(b).check(*both_values({
            "x": (rng.randn(B, Tn, F).astype(np.float32), [4, 2]),
            "c": cs}))
        got = t[0]["g2"].array.numpy()
        for step in range(4):
            np.testing.assert_allclose(got[0, step], (step + 2) * cs[0],
                                       rtol=1e-5)
        # the row of length 2 keeps its memory (3c) past its end: every
        # later step emits the same 4c
        np.testing.assert_allclose(got[1, 2], 4 * cs[1], rtol=1e-5)
        np.testing.assert_array_equal(got[1, 3], got[1, 2])

    def test_reverse_group(self, rng):
        def b(P):
            L = P.layer

            def step(x_t):
                m = L.memory(name="cum", size=3)
                return L.addto([x_t, m], name="cum", act="linear",
                               bias_attr=False)
            g = L.recurrent_group(step, input=_seq(P, "x", 3), reverse=True,
                                  name="g3")
            return [g, L.first_seq(g, name="suffix_sum")]
        xs = rng.randn(2, 4, 3).astype(np.float32)
        j, t = Net(b).check(*both_values({"x": (xs, [4, 2])}))
        got = t[0]["suffix_sum"].array.numpy()
        np.testing.assert_allclose(got[0], xs[0, :4].sum(0), rtol=1e-5)
        np.testing.assert_allclose(got[1], xs[1, :2].sum(0), rtol=1e-5)

    def test_gradients_flow(self, rng):
        def b(P):
            L = P.layer

            def step(x_t):
                m = L.memory(name="h", size=5)
                return L.fc([x_t, m], size=5, act="tanh", name="h")
            g = L.recurrent_group(step, input=_seq(P, "x", 4), name="g4")
            out = L.fc(L.last_seq(g, name="g4_last"), size=3, act="softmax",
                       name="out")
            return L.classification_cost(
                out, L.data("y", P.data_type.integer_value(3)), name="cost")
        j, t = Net(b, seed=0).check(*both_values({
            "x": (rng.randn(2, 3, 4).astype(np.float32), [3, 2]),
            "y": np.array([0, 2], np.int32)}), grad=True)
        for k in ("h.w0", "h.w1", "h.b"):
            assert float(t[2][k].abs().max()) > 0

    def test_lstm_step_memories(self, rng):
        """An LSTM cell state carried through a memory that no output
        reads (the step graph's roots include memory-linked layers)."""
        H = 4

        def b(P):
            L = P.layer

            def step(x_t):
                h = L.memory(name="ls", size=H)
                c = L.memory(name="ls@cell", size=H)
                proj = L.fc([x_t, h], size=4 * H, name="ls_in",
                            bias_attr=False)
                hl, _ = L.lstm_step(proj, h, c, size=H, name="ls",
                                    forget_bias=1.0)
                return hl
            return L.recurrent_group(step, input=_seq(P, "x", 3), name="lsg")
        Net(b).check(*both_values({"x": (
            rng.randn(3, 5, 3).astype(np.float32), [5, 2, 4])}), grad=True)


class TestBeamSearchOp:
    """The port's ops/beam over a Markov step, against the JAX op."""

    @staticmethod
    def _both(M, fn, **kw):
        jlog = jnp.log(jnp.asarray(M, jnp.float32))
        tlog = torch.log(torch.from_numpy(np.asarray(M, np.float32)))
        k = kw.get("beam_size", 1)
        # the state's one tensor places the port's search on the CPU
        jout = getattr(jbeam, fn)(lambda last, s: (jlog[last], s),
                                  {"z": jnp.zeros((kw["batch"], k))}, **kw)
        tout = getattr(tbeam, fn)(lambda last, s: (tlog[last.long()], s),
                                  {"z": torch.zeros((kw["batch"], k))}, **kw)
        for a, b in zip(tout, jout):
            if np.issubdtype(np.asarray(b).dtype, np.floating):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return [a.numpy() for a in tout]

    def test_greedy_matches_manual_rollout(self):
        M = np.random.RandomState(0).dirichlet(np.ones(4), size=4)
        tok, lens, _ = self._both(M, "greedy_search", batch=1, vocab=4,
                                  bos_id=1, eos_id=0, max_len=6)
        cur, out = 1, []
        for _ in range(6):
            cur = int(np.argmax(M[cur]))
            out.append(cur)
            if cur == 0:
                break
        assert list(tok[0][:int(lens[0])]) == out

    def test_scores_are_true_logprobs(self):
        M = np.random.RandomState(1).dirichlet(np.ones(4), size=4)
        tok, lens, sc = self._both(M, "beam_search", batch=2, beam_size=3,
                                   vocab=4, bos_id=1, eos_id=0, max_len=5)
        for b in range(2):
            for k in range(3):
                prev, total = 1, 0.0
                for t in tok[b, k, :lens[b, k]]:
                    total += np.log(M[prev, t])
                    prev = int(t)
                np.testing.assert_allclose(sc[b, k], total, rtol=1e-4,
                                           atol=1e-4)
            assert np.all(np.diff(sc[b]) <= 1e-6)

    def test_beam_finds_delayed_reward_path(self):
        M = np.array([[1.00, 0.00, 0.00, 0.00],
                      [0.05, 0.00, 0.45, 0.50],
                      [0.99, 0.005, 0.0025, 0.0025],
                      [0.30, 0.30, 0.20, 0.20]])
        tok, lens, _ = self._both(M, "beam_search", batch=1, beam_size=3,
                                  vocab=4, bos_id=1, eos_id=0, max_len=4)
        assert list(tok[0, 0][:int(lens[0, 0])]) == [2, 0]

    def test_state_gather_by_parent(self):
        """A counter state accumulating emitted tokens follows its beam:
        the final state equals each beam's bos + token prefix sums."""
        K = 2
        M = np.random.RandomState(2).dirichlet(np.ones(4) * 2, size=4)
        tlog = torch.log(torch.from_numpy(M.astype(np.float32)))
        jlog = jnp.log(jnp.asarray(M, jnp.float32))
        seen = {}

        def tstep(last, st):
            seen["sum"] = st["sum"] + last[..., None]
            return tlog[last.long()], {"sum": seen["sum"]}

        tok, lens, sc = tbeam.beam_search(
            tstep, {"sum": torch.zeros((1, K, 1), dtype=torch.int32)},
            batch=1, beam_size=K, vocab=4, bos_id=1, eos_id=0, max_len=4)
        jt, jl, js = jbeam.beam_search(
            lambda last, st: (jlog[last], {"sum": st["sum"] + last[..., None]}),
            {"sum": jnp.zeros((1, K, 1), jnp.int32)}, batch=1, beam_size=K,
            vocab=4, bos_id=1, eos_id=0, max_len=4)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
        assert tuple(tok.shape) == (1, K, 4)


class TestBeamSearchLayer:
    def test_generation_layer(self, rng):
        V, E, H, B = 6, 4, 5, 2

        def b(P):
            L = P.layer
            src = L.data("src", P.data_type.dense_vector(H))

            def step(emb_t):
                m = L.memory(name="dec_h", size=H, boot_layer=src)
                h = L.fc([emb_t, m], size=H, act="tanh", name="dec_h")
                return L.fc(h, size=V, act="softmax", name="dist")
            return L.beam_search(step, input=[L.GeneratedInput(
                size=V, embedding_name="word_emb", embedding_size=E)],
                bos_id=1, eos_id=0, beam_size=3, max_length=5, name="gen")
        net = Net(b, seed=0)
        assert "word_emb" in net.tparams.values
        j, t = net.check(*both_values({"src": rng.randn(B, H).astype(
            np.float32)}))
        v = t[0]["gen"]
        tok, lens, scores = (v.array.numpy(), v.sub_lengths.numpy(),
                             v.weights.numpy())
        assert tok.shape == (B, 3, 5)
        assert np.all(np.diff(scores, axis=1) <= 1e-6)
        for bi in range(B):
            for k in range(3):
                if lens[bi, k] < 5:
                    assert tok[bi, k, lens[bi, k] - 1] == 0


class TestCrossEntropyOverBeam:
    def _case(self, rng, B=3, S=4, K=3, fall_off=(False, True, False)):
        step_scores = rng.randn(B, S, K).astype(np.float32)
        parents = rng.randint(0, K, (B, S, K)).astype(np.int32)
        gold_scores = rng.randn(B, S).astype(np.float32)
        gold_slot = np.asarray(
            [-1 if f else rng.randint(0, K) for f in fall_off], np.int32)
        return step_scores, parents, gold_scores, gold_slot

    def test_matches_path_enumeration(self, rng):
        parity(jbeam.cross_entropy_over_beam, tbeam.cross_entropy_over_beam,
               list(self._case(rng)))

    def test_valid_mask_drops_slots(self, rng):
        sc, par, gsc, gslot = self._case(rng, fall_off=(True, True, False))
        valid = np.ones((3, 3), bool)
        valid[0, 2] = valid[1, 0] = False
        gslot[2] = 1
        parity(jbeam.cross_entropy_over_beam, tbeam.cross_entropy_over_beam,
               [sc, par, gsc, gslot, valid])

    def test_numeric_grad(self, rng):
        sc, par, gsc, gslot = self._case(rng, B=2, S=3, K=2,
                                         fall_off=(False, True))
        parity(jbeam.cross_entropy_over_beam, tbeam.cross_entropy_over_beam,
               [sc, par, gsc, gslot], wrt=(0, 2))

    def test_layer_surface(self, rng):
        B, S, K = 2, 3, 2

        def b(P):
            L, dt = P.layer, P.data_type
            return L.cross_entropy_over_beam(
                L.data("sc", dt.dense_vector(S * K)),
                L.data("par", dt.dense_vector(S * K)),
                L.data("gsc", dt.dense_vector(S)),
                L.data("gslot", dt.integer_value(K + 1)), name="beam_ce")
        sc, par, gsc, gslot = self._case(rng, B=B, S=S, K=K,
                                         fall_off=(False, True))
        Net(b).check(*both_values({
            "sc": sc.reshape(B, S * K), "par": par.reshape(B, S * K),
            "gsc": gsc, "gslot": gslot}))

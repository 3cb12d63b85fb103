"""The port's beam search, ``SequenceBatch`` and dtype flags against
``paddle_tpu``'s on the CPU.

``beam_search`` and ``greedy_search`` over a small GRU decoder cell
(the same numpy weights in both packages; a nested recurrent state
gathered along the beam axis), with a length penalty and with tied
candidates (ties to the lower flat index, as ``lax.top_k``; the final
order a stable sort); ``cross_entropy_over_beam`` (gold in and out of
the beam, masked slots) and its gradient; ``SequenceBatch`` built from
flat and nested lists (``from_list``, ``from_nested_list``) with every
view; ``param_dtype`` / ``compute_dtype`` and their flags.

Tolerances: tokens and lengths exactly; scores 1e-5 and gradients 1e-4
(of max(1, max|JAX value|)); ``SequenceBatch`` fields exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.core import ragged as jragged
from paddle_tpu.ops import beam as jbeam
from paddle_tpu_torch.core import dtypes as tdtypes
from paddle_tpu_torch.core import ragged as tragged
from paddle_tpu_torch.ops import beam as tbeam
from tests.torch_ops_util import assert_same, parity, to_j, to_t

torch.set_num_threads(1)

B, K, V, H = 3, 4, 11, 6


def _decoder(rng):
    return {"emb": (rng.randn(V, H) * 0.8).astype(np.float32),
            "u": (rng.randn(H, 3 * H) * 0.5).astype(np.float32),
            "w": (rng.randn(H, 3 * H) * 0.5).astype(np.float32),
            "out": (rng.randn(H, V) * 1.5).astype(np.float32)}


def _jstep(p):
    from paddle_tpu.ops import rnn as jrnn

    def step(tok, state):
        h, ctx = state["h"], state["ctx"]
        xp = (p["emb"][tok] + ctx) @ p["w"]
        nh = jrnn.gru_cell(xp.reshape(-1, 3 * H), h.reshape(-1, H), p["u"])
        nh = nh.reshape(h.shape)
        return jax.nn.log_softmax(nh @ p["out"], -1), {"h": nh, "ctx": ctx}
    return step


def _tstep(p):
    from paddle_tpu_torch.ops import rnn as trnn

    def step(tok, state):
        h, ctx = state["h"], state["ctx"]
        xp = (p["emb"][tok.long()] + ctx) @ p["w"]
        nh = trnn.gru_cell(xp.reshape(-1, 3 * H), h.reshape(-1, H), p["u"])
        nh = nh.reshape(h.shape)
        return torch.log_softmax(nh @ p["out"], -1), {"h": nh, "ctx": ctx}
    return step


def _state(rng, k):
    ctx = np.repeat(rng.randn(B, 1, H).astype(np.float32), k, axis=1)
    return {"h": np.zeros((B, k, H), np.float32), "ctx": ctx}


@pytest.mark.parametrize("length_penalty", [0.0, 0.7])
def test_beam_search_matches_jax(rng, length_penalty):
    p, st = _decoder(rng), _state(rng, K)
    jp = {k: to_j(v) for k, v in p.items()}
    tp = {k: to_t(v) for k, v in p.items()}
    args = (B, K, V, 1, 2, 7, length_penalty)
    jt = jbeam.beam_search(_jstep(jp), {k: to_j(v) for k, v in st.items()},
                           *args)
    tt = tbeam.beam_search(_tstep(tp), {k: to_t(v) for k, v in st.items()},
                           *args)
    assert_same(tt, jt, 1e-5)
    assert tt[0].dtype == torch.int32 and tuple(tt[0].shape) == (B, K, 7)


def test_greedy_search_matches_jax(rng):
    p, st = _decoder(rng), _state(rng, 1)
    jp = {k: to_j(v) for k, v in p.items()}
    tp = {k: to_t(v) for k, v in p.items()}
    jt = jbeam.greedy_search(_jstep(jp), {k: to_j(v) for k, v in st.items()},
                             B, V, 1, 2, 9)
    tt = tbeam.greedy_search(_tstep(tp), {k: to_t(v) for k, v in st.items()},
                             B, V, 1, 2, 9)
    assert_same(tt, jt, 1e-5)


def test_beam_search_ties_and_early_stop():
    """A step function whose log-probs tie across tokens and beams: the
    top-k keeps the lower flat index in both packages; every beam ends
    at EOS before ``max_len``, so the loop stops early."""
    table = np.full((V, V), -30.0, np.float32)
    table[1, [3, 4, 5, 6]] = np.log(0.25)         # four tied continuations
    table[3:7, 2] = 0.0                            # then EOS
    table[2, 2] = 0.0

    def jstep(tok, state):
        return to_j(table)[tok], state

    def tstep(tok, state):
        return to_t(table)[tok.long()], state

    st = np.zeros((2, K, 1), np.float32)
    jt = jbeam.beam_search(jstep, to_j(st), 2, K, V, 1, 2, 6)
    tt = tbeam.beam_search(tstep, to_t(st), 2, K, V, 1, 2, 6)
    assert_same(tt, jt, 1e-5)
    assert tt[0][0, :, 0].tolist() == [3, 4, 5, 6]
    assert tt[1].tolist() == [[2] * K] * 2


def test_cross_entropy_over_beam(rng):
    S = 4
    step_scores = rng.randn(B, S, K).astype(np.float32)
    parents = rng.randint(0, K, (B, S, K)).astype(np.int32)
    gold_scores = rng.randn(B, S).astype(np.float32)
    gold_slot = np.array([2, -1, 0], np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 1, 1]], bool)
    for mask in (None, valid):
        parity(lambda s, g: jbeam.cross_entropy_over_beam(
                   s, to_j(parents), g, to_j(gold_slot),
                   None if mask is None else to_j(mask)),
               lambda s, g: tbeam.cross_entropy_over_beam(
                   s, to_t(parents), g, to_t(gold_slot),
                   None if mask is None else to_t(mask)),
               [step_scores, gold_scores], wrt=(0, 1))


def test_tree_map_gathers_nested_state():
    state = {"a": torch.arange(12.0).reshape(2, 3, 2),
             "b": (torch.arange(6).reshape(2, 3), None)}
    parent = torch.tensor([[2, 2, 0], [1, 0, 1]])
    out = tbeam._gather_beams(state, parent)
    assert out["a"][0, 0].tolist() == [4.0, 5.0]
    assert out["b"][0].tolist() == [[2, 2, 0], [4, 3, 4]]
    assert out["b"][1] is None


def _seqs(rng):
    return [rng.randn(n, 3).astype(np.float32) for n in (5, 1, 17)]


def _views(sb):
    return [sb.data, sb.lengths, sb.mask(), sb.segment_ids(), sb.flat_data(),
            sb.batch_size, sb.max_len]


def test_sequence_batch_from_list(rng):
    seqs = _seqs(rng)
    j = jragged.SequenceBatch.from_list(seqs)
    t = tragged.SequenceBatch.from_list(seqs, device="cpu")
    assert_same(_views(t), _views(j), 0.0)
    assert t.data.dtype == torch.float32 and t.lengths.dtype == torch.int32
    ids = [np.arange(n, dtype=np.int64) for n in (3, 9)]
    j = jragged.SequenceBatch.from_list(ids, buckets=(4, 8), pad_value=-1)
    t = tragged.SequenceBatch.from_list(ids, buckets=(4, 8), pad_value=-1,
                                        device="cpu")
    assert_same(_views(t), _views(j), 0.0)
    assert t.data.dtype == torch.int32 and t.max_len == 16


def test_sequence_batch_nested(rng):
    nested = [[rng.randn(2, 4), rng.randn(3, 4)], [],
              [rng.randn(1, 4), rng.randn(1, 4), rng.randn(4, 4)]]
    j = jragged.SequenceBatch.from_nested_list(nested, dtype=np.float32)
    t = tragged.SequenceBatch.from_nested_list(nested, dtype=np.float32,
                                               device="cpu")
    assert_same(_views(t) + [t.sub_lengths, t.sub_segment_mask()],
                _views(j) + [j.sub_lengths, j.sub_segment_mask()], 0.0)
    np.testing.assert_array_equal(tragged.sub_lengths_matrix(nested),
                                  jragged.sub_lengths_matrix(nested))
    moved = t.to("cpu").with_data(t.data * 2)
    assert torch.equal(moved.sub_lengths, t.sub_lengths)
    with pytest.raises(ValueError):
        tragged.SequenceBatch(t.data, t.lengths).sub_segment_mask()


def test_sequence_batch_needs_a_device_without_a_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means that card")
    with pytest.raises(RuntimeError):
        tragged.SequenceBatch.from_list(_seqs(rng))


def test_dtype_flags():
    from paddle_tpu.utils.flags import GLOBAL_FLAGS as J
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as T
    assert T.get("compute_dtype") == J.get("compute_dtype")
    assert T.get("default_dtype") == J.get("default_dtype") == "float32"
    assert tdtypes.param_dtype() == torch.float32
    assert (tdtypes.name(tdtypes.compute_dtype())
            == jnp.dtype(jdtypes.compute_dtype()).name)
    old = T.get("compute_dtype")
    try:
        T.set("compute_dtype", "bf16")
        assert tdtypes.compute_dtype() == torch.bfloat16
    finally:
        T.set("compute_dtype", old)
    with pytest.raises(KeyError):
        T.set("no_such_flag", 1)


def test_ops_package_exports_and_loads_no_kernel():
    """``paddle_tpu_torch.ops`` exports what ``paddle_tpu.ops`` does, and
    importing it builds and loads no CUDA kernel (the kernels package
    is not even imported)."""
    import subprocess
    import sys

    import paddle_tpu.ops as jops
    import paddle_tpu_torch.ops as tops
    names = [n for n in dir(jops) if not n.startswith("_")
             and n not in ("pallas", "q8", "beam", "conv_bn", "detection")]
    for n in names:
        assert hasattr(tops, n), n
    code = ("import sys, paddle_tpu_torch.ops; "
            "print(any(m.startswith('paddle_tpu_torch.ops.kernels') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"

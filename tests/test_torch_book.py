"""The nine book chapters of ``tests/test_book.py`` trained through the
port's datasets, ``paddle_tpu_torch.batch`` and ``SGD.train`` on the CPU,
against ``paddle_tpu``.

Each chapter is the reference test's network and reader, built in both
packages by ``tests/torch_book_chapters.py`` (the networks that
``chip_smoke.py``'s ``book:`` phase trains on the card, here at
``SMALL`` widths), with the JAX package's parameters
(numpy draws, ``torch_layers_util.numpy_params``) carried into the port.
The JAX trainer takes the chapter's first ``STEPS`` batches; the port's
trainer runs the reference test's whole schedule. The port's first
``STEPS`` per-step costs lie within ``TOL`` of max(1, |JAX cost|) of
JAX's, and the reference test's assertion that the cost moves holds on
the port's costs. The quick-start chapter builds the bag-of-words network
of ``demos/quick_start/train_text.py`` inline with the port's layers and
holds it against the demo's own ``build("bow")``.
"""

import importlib.util
import itertools
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.reader import decorator as jdec
from paddle_tpu_torch.reader import decorator as tdec
from tests import torch_book_chapters as book
from tests.torch_layers_util import (carry, keep_global_seed,  # noqa: F401
                                    numpy_params)

for _P in (J, T):
    for _m in ("dataset", "trainer", "event", "reader", "evaluator",
               "optimizer", "models.text", "models.resnet",
               "models.seq2seq"):
        importlib.import_module(f"{_P.__name__}.{_m}")

pytestmark = pytest.mark.usefixtures("keep_global_seed")

TOL = 1e-4
STEPS = 4           # JAX steps each chapter is held to
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the reference test's schedule: samples read (None: the whole reader)
# and passes, per chapter
SCHEDULE = {"fit_a_line": (None, 10), "word2vec": (None, 1),
            "recommender": (None, 1), "sentiment": (512, 3),
            "image": (256, 3), "srl": (256, 3), "translation": (128, 2),
            "learn_to_rank": (None, 4), "quick_start": (None, 2)}


def _quick_start_demo():
    spec = importlib.util.spec_from_file_location(
        "qs_text", os.path.join(REPO, "demos", "quick_start", "train_text.py"))
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    return qs


def build(name, P):
    """Chapter ``name`` in ``P`` at ``book.SMALL``, its reader cut to the
    reference test's samples. The JAX package's quick-start network is
    the demo's own ``build("bow")``; the port's, the same layer calls."""
    kw = ({"cost": _quick_start_demo().build("bow")[1]}
          if name == "quick_start" and P is J else {})
    ch = book.chapter(name, P, **kw)
    n = SCHEDULE[name][0]
    if n is not None:
        ch.reader = P.reader.firstn(ch.reader, n)
    return ch


def _costs(P, out):
    return lambda e: out.append(e.cost) if isinstance(
        e, P.event.EndIteration) else None


def train_both(name, seed=3):
    """(JAX costs of the first STEPS batches, the port's costs of the whole
    schedule, the port's trainer)."""
    jc, tc = build(name, J), build(name, T)
    jtopo = J.topology.Topology([jc.cost] + jc.extra)
    ttopo = T.topology.Topology([tc.cost] + tc.extra)
    assert ([(s.name, tuple(s.shape)) for s in jtopo.param_specs()]
            == [(s.name, tuple(s.shape)) for s in ttopo.param_specs()])
    jp = numpy_params(jtopo, seed)
    tp = carry(jp, ttopo)
    jt = J.trainer.SGD(jc.cost, jp, jc.opt(), extra_layers=jc.extra)
    tt = T.trainer.SGD(tc.cost, tp, tc.opt(), extra_layers=tc.extra)
    J.init(seed=1234)
    T.init(seed=1234)
    jl, tl = [], []
    jt.train(J.batch(J.reader.firstn(jc.reader, STEPS * jc.batch), jc.batch),
             1, _costs(J, jl), feeding=jc.feeding)
    tt.train(T.batch(tc.reader, tc.batch), SCHEDULE[name][1], _costs(T, tl),
             feeding=tc.feeding)
    assert len(jl) == STEPS and len(tl) >= STEPS
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (i, a, b)
    return jl, tl, tt


def test_fit_a_line():
    _, costs, _ = train_both("fit_a_line")
    assert np.mean(costs[-3:]) < np.mean(costs[:3]) * 0.5, costs


def test_word2vec():
    _, costs, _ = train_both("word2vec")
    assert costs[-1] < costs[0], (costs[0], costs[-1])


def test_recommender():
    _, costs, _ = train_both("recommender")
    assert np.mean(costs[-5:]) < np.mean(costs[:5])


def test_understand_sentiment():
    _, costs, tt = train_both("sentiment")
    assert costs[-1] < costs[0] * 0.9, (costs[0], costs[-1])
    res = tt.evaluators.result()
    assert res["us_err"] < 0.35, res


def test_image_classification():
    _, costs, _ = train_both("image")
    assert np.mean(costs[-4:]) < np.mean(costs[:4]), costs


def test_label_semantic_roles():
    _, costs, _ = train_both("srl")
    assert np.mean(costs[-4:]) < np.mean(costs[:4]), costs


def test_machine_translation():
    _, costs, _ = train_both("translation")
    assert np.mean(costs[-4:]) < np.mean(costs[:4]), costs


def test_learn_to_rank(monkeypatch):
    # both packages fold a per-process decoration counter into a seeded
    # shuffle's order: start both at 0
    monkeypatch.setattr(jdec, "_shuffle_ids", itertools.count())
    monkeypatch.setattr(tdec, "_shuffle_ids", itertools.count())
    _, costs, _ = train_both("learn_to_rank")
    per_pass = np.asarray(costs).reshape(4, -1).mean(axis=1)
    assert per_pass[-1] < per_pass[0], per_pass


def test_quick_start_bow():
    _, costs, _ = train_both("quick_start")
    assert costs[-1] < costs[0], (costs[0], costs[-1])

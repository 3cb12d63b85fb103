"""Traffic made from the seed, by one generator for every mix.

A serving mix (the ``traffic`` object of a cell file) fixes a block of
request shapes: ``shapes`` requests whose prompt and output lengths are
the lognormal quantiles at (i + 0.5) / shapes of ``prompt`` and
``output`` (``median``, ``sigma``, clipped to ``min``..``max``), paired
in an order fixed by the mix alone, with a ``greedy_share`` of them
greedy and the rest sampled at ``temperature`` and ``top_k``. The
requests come block after block, each block the same shapes in an
order of its own drawn from the seed, so that every seed, and every
window of a few blocks, does the same work; token ids are drawn from
the seed independently per request, so no two prompts share a prefix.
Clients of a closed loop take the next request of the sequence when
their last one completes.
"""

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

SHAPE_SEED = 20240611      # fixes the pairing of lengths, for every seed


@dataclasses.dataclass
class Request:
    prompt: np.ndarray      # int32 ids
    max_new: int
    temperature: float
    top_k: int

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths: the lognormal quantiles of ``spec`` at
    (i + 0.5) / n, rounded and clipped."""
    nd = NormalDist(math.log(spec["median"]), spec["sigma"])
    q = np.array([math.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(np.rint(q), spec["min"], spec["max"]).astype(np.int64)


def shapes(mix: dict) -> List[tuple]:
    """The mix's fixed set of (prompt length, output length, greedy)."""
    n = int(mix["shapes"])
    prompts = quantile_lengths(mix["prompt"], n)
    outputs = quantile_lengths(mix["output"], n)
    pair = np.random.RandomState(SHAPE_SEED)
    prompts = prompts[pair.permutation(n)]
    outputs = outputs[pair.permutation(n)]
    greedy = np.arange(n) < round(mix["greedy_share"] * n)
    greedy = greedy[pair.permutation(n)]
    return [(int(p), int(o), bool(g))
            for p, o, g in zip(prompts, outputs, greedy)]


class Sequence:
    """The seed's order of the mix's shapes, block after block, with
    token ids drawn per request as it is taken."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.shapes = shapes(mix)
        ss = np.random.SeedSequence(int(seed) % (1 << 64))
        order_seed, ids_seed = ss.spawn(2)
        self._order = np.random.default_rng(order_seed)
        self._ids = np.random.default_rng(ids_seed)
        self.taken = 0

    def next(self) -> Request:
        i = self.taken
        self.taken += 1
        if i % len(self.shapes) == 0:
            self._perm = self._order.permutation(len(self.shapes))
        p, o, greedy = self.shapes[self._perm[i % len(self.shapes)]]
        ids = self._ids.integers(0, self.vocab, size=p, dtype=np.int32)
        return Request(prompt=ids, max_new=o,
                       temperature=0.0 if greedy
                       else float(self.mix["temperature"]),
                       top_k=0 if greedy else int(self.mix["top_k"]))


def prefill_keys(mix: dict, chunk: int, buckets, block_size: int):
    """Every (context offset, chunk bucket) a prompt of the mix can
    prefill: the chunk programs the window can meet."""
    keys = set()
    for length in range(mix["prompt"]["min"], mix["prompt"]["max"] + 1):
        for off in range(0, length, chunk):
            c = min(length - off, chunk)
            keys.add((off, min(b for b in buckets if b >= c)))
    return sorted(keys)


def train_batches(torch, seed: int, n: int, batch: int, seq: int,
                  vocab: int, device):
    """``n`` batches of uniform ids [n, batch, seq + 1] on ``device``,
    drawn there from the seed in one call: inputs are the first ``seq``,
    targets the last ``seq`` (shifted by one)."""
    from perfbench.weights import torch_seed
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 1 << 20))
    return torch.randint(0, vocab, (n, batch, seq + 1), generator=g,
                         dtype=torch.int64, device=device).to(torch.int32)

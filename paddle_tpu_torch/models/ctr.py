"""CTR wide&deep model — the high-dimensional-sparse showcase
(counterpart of ``paddle_tpu/models/ctr.py``).

Reference: v1_api_demo/quick_start/trainer_config.lr.py (wide sparse
logistic regression over bag-of-words), trainer_config.emb.py (the deep
embedding variant), and the sparse-remote-update training path those ran
on (trainer/RemoteParameterUpdater.h:265 sharded embedding rows across
pservers; math/SparseRowMatrix.h row-sparse grads). BASELINE config 5.

On one card the wide weight [wide_dim, 2] and the embedding table
[vocab, emb_dim] are dense tensors; lookups are gathers, and the
row-sparse gradient materialises through the scatter-add in the
gather's backward. ``ctr_dist_rules`` shards them over a mesh's
``model`` axis (``SGD(parallel=DistConfig(mesh, ctr_dist_rules()))``).
"""

from typing import Sequence

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer


def ctr_wide_deep(wide_dim: int, vocab_size: int, emb_dim: int = 64,
                  hidden: Sequence[int] = (128, 64), name: str = "ctr"):
    """Build the wide&deep click-through model.

    Inputs (feed order): ``wide`` sparse_binary_vector(wide_dim) — the
    cross/id features; ``deep_ids`` integer_value_sequence(vocab_size) —
    the deep-side feature ids; ``label`` integer_value(2).
    Returns (prediction LayerOutput [b, 2] softmax, cost LayerOutput).
    """
    wide_in = layer.data("wide", paddle.data_type.sparse_binary_vector(
        wide_dim))
    ids = layer.data("deep_ids", paddle.data_type.integer_value_sequence(
        vocab_size))
    lbl = layer.data("label", paddle.data_type.integer_value(2))

    emb = layer.embedding(ids, emb_dim, name=f"{name}_emb")
    deep = layer.pool(emb, pooling_type=paddle.pooling.Avg(),
                      name=f"{name}_pool")
    for i, h in enumerate(hidden):
        deep = layer.fc(deep, h, act=paddle.activation.Relu(),
                        name=f"{name}_fc{i}")

    # wide&deep join: one fc summing the sparse wide input and the deep
    # tower (multi-input fc = summed projections, the MixedLayer pattern)
    out = layer.fc([wide_in, deep], 2, act=paddle.activation.Softmax(),
                   name=f"{name}_out")
    cost = layer.classification_cost(out, lbl, name=f"{name}_cost")
    return out, cost


def ctr_dist_rules(name: str = "ctr"):
    """Sharding rules for the high-dim tables (the sparse_remote_update
    slot): embedding over vocab, wide weight over its input dim."""
    from paddle_tpu_torch.parallel import spmd
    return [
        spmd.embedding_vocab_rule(rf"^{name}_emb\.w$"),
        spmd.fc_row_rule(rf"^{name}_out\.w0$"),   # wide [wide_dim, 2]
    ]


def synthetic_reader(wide_dim: int, vocab_size: int, n: int = 512,
                     seed: int = 0, nnz: int = 8, seq_len: int = 10):
    """Synthetic CTR samples with learnable structure: the label depends
    on whether feature ids fall in the 'clicky' half of each table."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            wide = sorted(set(rng.randint(0, wide_dim, nnz).tolist()))
            ids = rng.randint(0, vocab_size, rng.randint(3, seq_len))
            signal = (np.mean([w < wide_dim // 2 for w in wide])
                      + np.mean(ids < vocab_size // 2)) / 2
            label = int(signal > 0.5)
            yield wide, [int(i) for i in ids], label

    return reader

"""Model sizes from a configuration file, and weights made from the seed.

The weights are the benchmark's input, made on the device the run uses
with a ``torch.Generator`` there, one draw per leaf of the port's
parameter tree (``transformer.init_params``' layout and scales), so the
program and the plain reference get the same values from the same
seed. Each leaf has a generator of its own, seeded from (seed, leaf), so
one leaf can be made again alone.
"""

import dataclasses
import math

import numpy as np

# the leaves in a fixed order: (name, blocks?, matmul weight?)
LEAVES = (("embed", False, False), ("pos", False, False),
          ("ln1", True, False), ("ln1_b", True, False),
          ("qkv", True, True), ("attn_out", True, True),
          ("ln2", True, False), ("ln2_b", True, False),
          ("mlp_in", True, True), ("mlp_out", True, True),
          ("ln_f", False, False), ("ln_f_b", False, False))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A GPT-2 configuration file's sizes under the port's names."""
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    max_len: int
    dropout: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads


def sizes(model: dict) -> Sizes:
    """``model`` is a configuration file's object (Hugging Face's GPT-2
    keys)."""
    D = int(model["n_embd"])
    return Sizes(vocab=int(model["vocab_size"]), d_model=D,
                 n_heads=int(model["n_head"]), n_layers=int(model["n_layer"]),
                 d_ff=int(model.get("n_inner") or 4 * D),
                 max_len=int(model["n_positions"]),
                 dropout=float(model["resid_pdrop"]))


def torch_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed (any whole number)
    and ``parts``."""
    words = [int(seed) % (1 << 64)] + [int(p) for p in parts]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def shape_and_scale(sz: Sizes, name: str):
    """(shape, scale) of a leaf: normal draws times ``scale``, or a
    constant for the norms (scale None, value 1 for a gain, 0 for a
    bias)."""
    D, F, L, V = sz.d_model, sz.d_ff, sz.n_layers, sz.vocab
    s = 1.0 / math.sqrt(D)
    return {
        "embed": ((V, D), s),
        "pos": ((sz.max_len, D), 0.02),
        "ln1": ((L, D), None), "ln1_b": ((L, D), None),
        "qkv": ((L, D, 3 * D), s),
        "attn_out": ((L, D, D), s / math.sqrt(2 * L)),
        "ln2": ((L, D), None), "ln2_b": ((L, D), None),
        "mlp_in": ((L, D, F), s),
        "mlp_out": ((L, F, D), 1.0 / math.sqrt(F) / math.sqrt(2 * L)),
        "ln_f": ((D,), None), "ln_f_b": ((D,), None),
    }[name]


def leaf(torch, sz: Sizes, name: str, seed: int, device, dtype=None):
    """One leaf as fp32 (or ``dtype``) on ``device``."""
    index = [n for n, _, _ in LEAVES].index(name)
    shape, scale = shape_and_scale(sz, name)
    if scale is None:
        fill = 0.0 if name.endswith("_b") else 1.0
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
    else:
        g = torch.Generator(device=device)
        g.manual_seed(torch_seed(seed, index))
        t = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device)
        t.mul_(scale)
    return t if dtype is None else t.to(dtype)


def tree(torch, sz: Sizes, seed: int, device, matmul_dtype=None) -> dict:
    """The parameter tree: matmul weights in ``matmul_dtype`` (the
    serving dict's bf16) or fp32 like every other leaf."""
    out = {"blocks": {}}
    for name, in_blocks, matmul in LEAVES:
        t = leaf(torch, sz, name, seed, device,
                 matmul_dtype if matmul else None)
        (out["blocks"] if in_blocks else out)[name] = t
    return out


def flat(tree_: dict) -> dict:
    """{leaf name: tensor} in ``LEAVES`` order."""
    return {name: (tree_["blocks"] if b else tree_)[name]
            for name, b, _ in LEAVES}

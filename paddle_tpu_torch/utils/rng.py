"""Deterministic RNG key management (counterpart of
``paddle_tpu/utils/rng.py``): one root threefry key folded by a stable
hash of a parameter's name, so initialisation is reproducible and
order-free, and draws the JAX package's key for the same seed and name
(``ops/prng.fold_in``). Keys are int64 [2] tensors of uint32 words,
kept on the host."""

import time
import zlib

from paddle_tpu_torch.ops import prng


class KeySource:
    """Derives named subkeys from a root seed via fold_in on a stable hash."""

    def __init__(self, seed: int = None):
        if seed is None or seed == 0:
            from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
            seed = GLOBAL_FLAGS.get("seed", 0)
            if seed == 0:
                seed = int(time.time()) & 0x7FFFFFFF
        self.seed = int(seed)
        self._root = prng.prng_key(self.seed)

    def named(self, name: str):
        """Stable per-name key: fold_in(root, crc32(name))."""
        return prng.fold_in(self._root,
                            zlib.crc32(name.encode()) & 0x7FFFFFFF)

    def step(self, name: str, step: int):
        """Per-name, per-step key (dropout etc.)."""
        return prng.fold_in(self.named(name), step)


_GLOBAL = None


def global_key_source() -> KeySource:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = KeySource()
    return _GLOBAL


def reset_global_seed(seed: int):
    global _GLOBAL
    _GLOBAL = KeySource(seed)
    return _GLOBAL

"""The port's chunk prefill (``prefill_into_blocks``) against
``paddle_tpu``'s XLA path (``pallas="off"``), on the configs, pools and
tolerances of ``tests/test_torch_transformer.py``: cold and contextful
chunks on scrambled pages, padded chunk rows that must not write.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.models import transformer as tt
from test_torch_transformer import (BS, CONFIGS, IDS, _cfgs, _close,
                                    _params, _pool)


def _walk_port(tp, tcfg, pool, prompt, pages, chunks):
    off, lg = 0, None
    for c in chunks:
        bucket = 8 if c <= 8 else 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :c] = prompt[off:off + c]
        pv = pages[:off // BS + -(-bucket // BS)]
        lg, pool = tt.prefill_into_blocks(
            tp, pool, torch.from_numpy(padded), c, torch.from_numpy(pv),
            tcfg, block_size=BS)
        off += c
    return lg, pool


def _walk_jax(jp, jcfg, pool, prompt, pages, chunks):
    off, lg = 0, None
    for c in chunks:
        bucket = 8 if c <= 8 else 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :c] = prompt[off:off + c]
        pv = pages[:off // BS + -(-bucket // BS)]
        lg, pool = jt.prefill_into_blocks(
            jp, pool, jnp.asarray(padded), jnp.asarray(c, jnp.int32),
            jnp.asarray(pv, jnp.int32), jcfg, block_size=BS, pallas="off")
        off += c
    return lg, pool


@pytest.mark.parametrize("chunks", [(5,), (16, 13), (8, 16, 3)],
                         ids=["cold-padded", "context", "three-chunks"])
@pytest.mark.parametrize("gqa,rope", CONFIGS, ids=IDS)
def test_prefill_into_blocks_matches(gqa, rope, chunks, rng):
    """Cold and contextful chunks on scrambled pages; padded chunk rows
    map to page-table entries past the allocation (0 here, a block
    another request may own) and must not write."""
    jcfg, tcfg = _cfgs(gqa, rope)
    jp, tp = _params(jcfg, tcfg, seed=1)
    nblocks = 10
    pool = _pool(rng, tcfg, nblocks)
    n = sum(chunks)
    prompt = rng.randint(0, 64, n).astype(np.int32)
    used = -(-n // BS)
    pages = np.zeros(8, np.int32)                # unallocated tail = 0
    pages[:used] = rng.permutation(np.arange(1, nblocks))[:used]
    jl, jpool = _walk_jax(jp, jcfg, {k: jnp.asarray(a) for k, a in
                                     pool.items()}, prompt, pages, chunks)
    tpool = {k: torch.from_numpy(a.copy()) for k, a in pool.items()}
    tl, tpool = _walk_port(tp, tcfg, tpool, prompt, pages, chunks)
    assert tl.shape == (1, 64)
    _close(tl, jl)
    for k in ("k", "v"):
        _close(tpool[k], jpool[k])
        # block 0 backs only padded rows: its bytes never change
        np.testing.assert_array_equal(tpool[k][:, :, :BS].numpy(),
                                      pool[k][:, :, :BS])

"""KV-block transfer wire: pool blocks serialized for prefix transfer and
spill — the port's counterpart of ``paddle_tpu/serving/transfer.py``,
byte for byte the same wire.

One payload is an ordered CHAIN of (content digest, block rows) pairs
sliced out of the head-major pool (k/v ``[L, Hkv, M, Dh]``; int8/int4
pools add the ``[L, Hkv, M]`` fp32 scale tables, which travel WITH their
block), stamped with the pool layout / kv_dtype / per-block slab shape
so a mismatched receiver refuses loudly instead of adopting garbage.

The wire: ``PTKV`` magic, ``<II`` version and header length, a JSON
header naming layout, kv_dtype, block size, each array's slab shape and
dtype (numpy's names: ``"bfloat16"``, ``"float32"``, ``"int8"``) and the
hex digests, then each block's slabs in ``ARRAY_ORDER`` as raw C-order
buffers. bf16 slabs travel as their raw 2-byte words: numpy has no
bfloat16, and the port reads and writes them through torch alone.

Serialization reads the shipped slabs off the card with one gather and
one device-to-host copy per pool leaf (blocking, on the current stream:
every earlier write to those rows is complete before it reads).
``write_blocks`` writes a deserialized chain IN PLACE, one
``index_copy_`` per pool leaf: the pool tensors the engine's captured
graphs read keep their addresses.
"""

import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"PTKV"
VERSION = 1

# per-block arrays ride in this order (when present in the pool)
ARRAY_ORDER = ("k", "v", "k_scale", "v_scale")

# the pool layout the stamp names: head-major [L, Hkv, M, Dh], the JAX
# package's ``POOL_LAYOUT``
POOL_LAYOUT = "head_major"

# torch dtypes under the names the JAX package stamps (numpy's)
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.int8: "int8"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    """The stamp's name for a pool dtype."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no KV wire name for pool dtype {dtype}") from None


def _block_slab(leaf: torch.Tensor, block: int, block_size: int):
    """One block's rows of a pool leaf: the position axis is axis 2 of
    the 4D value arrays and the trailing axis of the 3D scale tables."""
    s = block * block_size
    return leaf[:, :, s:s + block_size]


def pool_meta(cache, block_size: int, kv_dtype: str = "none") -> dict:
    """The stamp a payload carries (and ``check_pool_match`` verifies):
    pool layout, KV storage width, block size, and each array's
    per-block slab shape + dtype."""
    arrays = {}
    for name in ARRAY_ORDER:
        if name not in cache:
            continue
        leaf = cache[name]
        shape = list(leaf.shape)
        shape[2] = int(block_size)
        arrays[name] = {"shape": shape, "dtype": _dtype_name(leaf.dtype)}
    return {"layout": POOL_LAYOUT, "kv_dtype": str(kv_dtype or "none"),
            "block_size": int(block_size), "arrays": arrays}


def read_blocks(cache, block_ids: Sequence[int], block_size: int
                ) -> List[Dict[str, torch.Tensor]]:
    """The slabs of ``block_ids`` (in order) as host tensors, one
    ``{name: slab}`` per block: one gather and one blocking copy to the
    host per pool leaf."""
    if not block_ids:
        return []
    n, bs = len(block_ids), int(block_size)
    names = [nm for nm in ARRAY_ORDER if nm in cache]
    rows = np.concatenate([np.arange(int(b) * bs, int(b) * bs + bs)
                           for b in block_ids])
    idx = torch.from_numpy(rows).to(cache[names[0]].device)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for nm in names:
        leaf = cache[nm]
        g = leaf.index_select(2, idx)
        g = g.reshape(*leaf.shape[:2], n, bs, *leaf.shape[3:])
        g = g.movedim(2, 0).contiguous().cpu()
        for i in range(n):
            out[i][nm] = g[i]
    return out


def _slab_bytes(slab) -> bytes:
    if isinstance(slab, torch.Tensor):
        t = slab.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(slab)).tobytes()


def serialize_raw_blocks(meta: dict,
                         items: Sequence[Tuple[bytes, Dict[str, object]]],
                         trace: Optional[str] = None) -> bytes:
    """Pack already-read ``(digest, {name: slab})`` pairs under a
    prebuilt :func:`pool_meta` stamp: slabs read off the pool and slabs
    round-tripped through a spill tier mix in one chain-ordered
    payload."""
    meta = dict(meta)
    meta["digests"] = [bytes(d).hex() for d, _ in items]
    if trace:
        meta["trace"] = str(trace)
    names = [n for n in ARRAY_ORDER if n in meta["arrays"]]
    header = json.dumps(meta).encode("utf-8")
    out = [MAGIC, struct.pack("<II", VERSION, len(header)), header]
    for _, arrays in items:
        for n in names:
            out.append(_slab_bytes(arrays[n]))
    return b"".join(out)


def serialize_blocks(cache, block_ids: Sequence[int],
                     digests: Sequence[bytes], block_size: int,
                     kv_dtype: str = "none",
                     trace: Optional[str] = None) -> bytes:
    """Pack ``block_ids``'s pool rows (chain order, one digest per
    block) into one stamped payload; ``trace`` rides in the header."""
    if len(block_ids) != len(digests):
        raise ValueError(f"{len(block_ids)} blocks vs "
                         f"{len(digests)} digests")
    slabs = read_blocks(cache, block_ids, block_size)
    return serialize_raw_blocks(pool_meta(cache, block_size, kv_dtype),
                                list(zip(digests, slabs)), trace=trace)


def deserialize_blocks(payload: bytes
                       ) -> Tuple[dict, List[Tuple[bytes,
                                                   Dict[str, torch.Tensor]]]]:
    """Unpack a payload into its stamp + the ordered
    ``(digest, {array name: host slab tensor})`` chain."""
    if payload[:4] != MAGIC:
        raise ValueError("not a KV transfer payload (bad magic)")
    version, hlen = struct.unpack_from("<II", payload, 4)
    if version != VERSION:
        raise ValueError(f"KV payload version {version}, expected "
                         f"{VERSION}")
    meta = json.loads(payload[12:12 + hlen].decode("utf-8"))
    names = [n for n in ARRAY_ORDER if n in meta["arrays"]]
    specs = []
    for n in names:
        dt = meta["arrays"][n]["dtype"]
        if dt not in _DTYPES:
            raise ValueError(f"KV payload array {n!r} of dtype {dt!r}: one "
                             f"of {sorted(_DTYPES)}")
        specs.append((n, tuple(meta["arrays"][n]["shape"]), _DTYPES[dt]))
    view = memoryview(payload)
    off = 12 + hlen
    blocks = []
    for hexd in meta["digests"]:
        arrays = {}
        for n, shape, dt in specs:
            nbytes = int(np.prod(shape)) * dt.itemsize
            if off + nbytes > len(payload):
                raise ValueError(f"KV payload size mismatch: truncated at "
                                 f"{len(payload)} bytes")
            # a private, writable copy of the raw words, typed as the
            # pool's dtype (bf16 included)
            arrays[n] = torch.frombuffer(bytearray(view[off:off + nbytes]),
                                         dtype=dt).reshape(shape)
            off += nbytes
        blocks.append((bytes.fromhex(hexd), arrays))
    if off != len(payload):
        raise ValueError(f"KV payload size mismatch: consumed {off} of "
                         f"{len(payload)} bytes")
    return meta, blocks


def check_pool_match(meta: dict, cache, block_size: int,
                     kv_dtype: str = "none"):
    """Refuse a payload whose stamp does not match the receiving pool:
    adopting bytes across a layout / storage-width / geometry mismatch
    would poison the prefix cache silently."""
    want = pool_meta(cache, block_size, kv_dtype)
    for key in ("layout", "kv_dtype", "block_size", "arrays"):
        if meta.get(key) != want[key]:
            raise ValueError(
                f"KV payload {key} mismatch: payload "
                f"{meta.get(key)!r} vs pool {want[key]!r}")


def write_blocks(cache,
                 writes: Sequence[Tuple[int, Dict[str, torch.Tensor]]],
                 block_size: int):
    """Write a deserialized chain into ``cache`` IN PLACE: one upload and
    one ``index_copy_`` per pool leaf for the whole chain, on the current
    stream. Every leaf keeps its storage (the captured graphs read it
    where it lies); dtypes must already match (``check_pool_match``), so
    the copy is bitwise."""
    if not writes:
        return
    bs = int(block_size)
    rows = np.concatenate([np.arange(int(b) * bs, int(b) * bs + bs)
                           for b, _ in writes])
    idx = None
    for name in writes[0][1]:
        leaf = cache[name]
        src = torch.cat([arrays[name] for _, arrays in writes], dim=2)
        if src.dtype != leaf.dtype:
            raise ValueError(f"KV slab {name!r} is {src.dtype}, the pool "
                             f"holds {leaf.dtype}")
        if idx is None:
            idx = torch.from_numpy(rows).to(leaf.device)
        leaf.index_copy_(2, idx, src.to(leaf.device))

"""Host-side block allocator + prefix cache for the paged KV pool — the
port's own copy of ``paddle_tpu/serving/blocks.py`` (pure numpy and
hashlib; digests are byte-identical to the JAX package's).

- **free list** — blocks never touched or fully released;
- **refcounts** — a block holding a shared prompt prefix is referenced
  by every slot whose page table maps it; it frees only when the LAST
  holder releases;
- **prefix cache** — full prompt blocks are published under a
  content-chain hash (:func:`chain_hash` over the parent digest + the
  block's token ids, so a hit certifies the whole prefix);
- **LRU** — a cached block whose refcount drops to 0 parks in an LRU;
  allocation pressure evicts oldest-first (un-publishing its hash), and
  ``on_evict`` lets a spill store (``serving/tiers.py``) take the block
  on its way out.
"""

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np

# chain root: the hash of "no prefix" — the same salt as the JAX
# package, so digests agree across the two
ROOT_HASH = b"paddle-tpu-paged-kv-root"


def chain_hash(parent: bytes, tokens) -> bytes:
    """Digest of one full prompt block given its prefix digest."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def prompt_block_hashes(prompt: np.ndarray, block_size: int
                        ) -> List[bytes]:
    """Chain digests of every FULL block of ``prompt``."""
    out, h = [], ROOT_HASH
    for i in range(len(prompt) // block_size):
        h = chain_hash(h, prompt[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


class BlockPool:
    """Refcounted allocator over ``num_blocks`` KV blocks with a
    content-addressed prefix cache and LRU eviction of refcount-0
    cached blocks.

    Reservation protocol: the engine reserves a request's worst-case
    block count at admission (:meth:`reserve`) and allocates lazily as
    positions are written (:meth:`alloc` consumes one reservation), so
    decode never stalls mid-flight on an empty pool."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need >=1 blocks of >=1 tokens, got "
                             f"{num_blocks}x{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = deque(range(self.num_blocks))
        self._ref = np.zeros(self.num_blocks, np.int64)
        self._hash: Dict[int, bytes] = {}       # cached block -> digest
        self._index: Dict[bytes, int] = {}      # digest -> cached block
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._reserved = 0
        self.evictions = 0                      # lifetime LRU evictions
        # demotion hook: on_evict(block, digest) when alloc() evicts a
        # refcount-0 cached block, BEFORE the new holder writes its rows:
        # the bytes still match the digest, so a spill store can
        # serialize them. unpublish() does not fire it (the bytes are
        # about to stop matching the digest there)
        self.on_evict = None

    # -- occupancy ---------------------------------------------------------
    @property
    def free_count(self) -> int:
        """Blocks holding nothing at all (not even cached content)."""
        return len(self._free)

    @property
    def cached_free_count(self) -> int:
        """Refcount-0 blocks parked in the LRU (evictable cache)."""
        return len(self._lru)

    @property
    def allocatable(self) -> int:
        """Blocks an alloc() could return right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    @property
    def in_use(self) -> int:
        """Blocks referenced by at least one live slot."""
        return self.num_blocks - self.allocatable

    @property
    def reserved(self) -> int:
        return self._reserved

    @property
    def cached_count(self) -> int:
        """Blocks published in the prefix cache (any refcount)."""
        return len(self._index)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def lru_oldest(self) -> Optional[int]:
        """The refcount-0 cached block ``alloc()`` would evict next (None
        when the LRU is empty): a bulk adopter stops before evicting its
        own chain's head."""
        return next(iter(self._lru), None)

    @property
    def idle(self) -> bool:
        """True when no slot holds a block and nothing is reserved."""
        return self._reserved == 0 and self.in_use == 0

    # -- reservation -------------------------------------------------------
    def can_reserve(self, n: int) -> bool:
        return self._reserved + n <= self.allocatable

    def reserve(self, n: int):
        if not self.can_reserve(n):
            raise RuntimeError(
                f"reserve({n}): only {self.allocatable - self._reserved} "
                f"unreserved blocks left of {self.num_blocks}")
        self._reserved += n

    def unreserve(self, n: int):
        if n > self._reserved:
            raise RuntimeError(f"unreserve({n}) exceeds reservation "
                               f"{self._reserved}")
        self._reserved -= n

    # -- lifecycle ---------------------------------------------------------
    def alloc(self) -> int:
        """One private block (refcount 1), consuming one reservation.
        Prefers never-cached free blocks; under pressure evicts the
        LRU-oldest refcount-0 cached block (un-publishing its hash)."""
        if self._reserved < 1:
            raise RuntimeError("alloc() without a reservation")
        self._reserved -= 1
        if self._free:
            b = self._free.popleft()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)      # oldest first
            h = self._hash.pop(b)
            del self._index[h]
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(b, h)
        else:
            raise RuntimeError("block pool exhausted despite reservation")
        self._ref[b] = 1
        return b

    def share(self, block: int):
        """One more holder of ``block`` (a prefix-cache hit). Revives a
        refcount-0 cached block out of the LRU."""
        if self._ref[block] == 0:
            if block not in self._lru:
                raise RuntimeError(f"share({block}): block is free, "
                                   f"not cached")
            del self._lru[block]
        self._ref[block] += 1

    def release(self, block: int):
        """Drop one holder. At refcount 0 a cache-published block parks
        in the LRU (MRU end); a private one returns to the free list."""
        if self._ref[block] < 1:
            raise RuntimeError(f"release({block}): refcount already 0")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            if block in self._hash:
                self._lru[block] = None
            else:
                self._free.append(block)

    # -- prefix cache ------------------------------------------------------
    def cached_digests(self, limit: Optional[int] = None) -> List[bytes]:
        """Digests published in the prefix cache, hottest first (blocks
        with holders, then the LRU newest to oldest): the ``hbm`` rows
        of ``health()``'s tier listing."""
        hot = [self._hash[b] for b in self._hash if self._ref[b] > 0]
        cold = [self._hash[b] for b in reversed(self._lru)]
        out = hot + cold
        return out[:limit] if limit else out

    def lookup(self, digest: bytes) -> Optional[int]:
        """Cached block for ``digest`` (LRU-parked ones included)."""
        return self._index.get(digest)

    def publish(self, digest: bytes, block: int):
        """Register ``block`` as the cached carrier of ``digest``. No-op
        when the digest is already cached (first writer wins) or the
        block already carries another digest."""
        if digest in self._index or block in self._hash:
            return
        self._index[digest] = block
        self._hash[block] = digest

    def unpublish(self, block: int):
        """Drop ``block``'s prefix-cache entry, if any. The
        preempt-to-blocks resume calls this on the revived partial tail
        block right before decoding writes into it again: its bytes are
        about to stop matching the digest. A refcount-0 block parked in
        the LRU loses its place there too and returns to the free
        list."""
        h = self._hash.pop(block, None)
        if h is None:
            return
        del self._index[h]
        if block in self._lru:
            del self._lru[block]
            self._free.append(block)

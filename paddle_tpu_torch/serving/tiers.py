"""Tiered prefix-cache spill store: host DRAM -> disk, below the card's
pool — the port's own copy of ``paddle_tpu/serving/tiers.py``; the two
read each other's files.

:class:`TieredStore` turns the block pool's LRU eviction into demotion:
the engine serializes each evicted refcount-0 cached block with the
transfer wire (``serving/transfer.serialize_blocks``: values, scales and
the layout/kv_dtype stamp, so the wire format IS the spill format and
re-adoption reuses ``import_prefix``'s machinery) and parks the payload
here:

- **DRAM tier** — a bytes-bounded in-memory LRU of per-digest payloads.
  Pressure demotes oldest-first to the disk tier (or drops, when no
  disk tier is configured).
- **Disk tier** — a bytes-bounded directory of files, one per digest,
  framed as ``PTT1`` + a 16-byte blake2b sum of the payload + the
  payload, published atomically (a dot-prefixed temp name, then
  ``os.replace``; no fsync: a cache needs torn-file detection, not
  durability, and the checksum provides it). Pressure deletes
  oldest-first.

Per-digest granularity is sound because a content-chain digest
certifies its WHOLE prefix: re-adoption walks the chain in order and
stops at the first tier miss, as admission walks the pool's cache.

A corrupt or truncated disk file (bad magic, checksum mismatch, short
read) is a MISS, never an exception on the admission path: the file is
quarantined (renamed ``*.corrupt``) and counted
(``engine_tier_corrupt_total``). So is a payload whose stamp no longer
matches the pool: the engine calls :meth:`quarantine`. An existing
directory is adopted again at start.

Pure host state (stdlib only).
"""

import hashlib
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.observe import metrics as _metrics

TIERS = ("dram", "disk")

# disk-tier file framing: magic + 16-byte blake2b of the payload, then
# the payload itself (which carries its own PTKV stamp inside)
_FILE_MAGIC = b"PTT1"
_SUM_BYTES = 16


def _payload_sum(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=_SUM_BYTES).digest()


class TieredStore:
    """Bounded DRAM→disk spill store for serialized prefix blocks.

    ``dram_bytes`` caps the in-memory tier (0 disables it — demotions
    go straight to disk); ``disk_bytes`` caps the disk tier (0 or a
    missing ``disk_dir`` disables it — DRAM pressure then drops
    oldest-first). ``registry`` receives the tier gauges/counters under
    the ``engine_tier_*`` names so one engine ``/metrics`` scrape (and,
    through the fleet aggregator, one router scrape) answers for the
    whole hierarchy.

    An existing ``disk_dir`` is re-adopted on construction: published
    ``*.kv`` files are re-indexed oldest-mtime-first (the post-restart
    warm start), temp and quarantined files are ignored. Integrity is
    verified lazily at :meth:`get` — a torn or bit-flipped file from a
    killed process is caught by the checksum then, quarantined, and
    served as a miss.
    """

    def __init__(self, *, dram_bytes: int = 0, disk_bytes: int = 0,
                 disk_dir: Optional[str] = None,
                 registry: Optional[_metrics.Registry] = None):
        self.dram_bytes = max(int(dram_bytes), 0)
        self.disk_bytes = max(int(disk_bytes), 0)
        self.disk_dir = disk_dir if (disk_dir and self.disk_bytes) \
            else None
        # digest -> payload bytes (DRAM) / file size (disk); both LRU:
        # oldest first, move_to_end on hit
        self._dram: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._disk: "OrderedDict[bytes, int]" = OrderedDict()
        self._dram_used = 0
        self._disk_used = 0
        # bumped every time a digest leaves the store ENTIRELY (budget
        # eviction, quarantine, unreadable file) — the fleet cache
        # directory's invalidation fence. A router that advertised this
        # replica's digests compares the epoch stamped on health docs
        # AND on every op result: a bump between health scrapes tells
        # it the advertisement is stale NOW, not at the next cadence.
        # Demotions (dram -> disk) do not bump: the digest still serves.
        self.eviction_epoch = 0
        reg = registry if registry is not None else _metrics.Registry()
        self.metrics = reg
        self._m_bytes = reg.gauge(
            "engine_tier_bytes", "spill bytes resident per tier "
            "(label tier) — HBM occupancy lives in the block gauges")
        self._m_entries = reg.gauge(
            "engine_tier_entries", "spilled block payloads resident "
            "per tier (label tier)")
        self._m_demotions = reg.counter(
            "engine_tier_demotions_total", "block payloads written "
            "INTO a tier (label tier): hbm->dram evictions land in "
            "dram, dram pressure cascades into disk")
        self._m_promotions = reg.counter(
            "engine_tier_promotions_total", "block payloads served "
            "OUT of a tier back toward HBM (label tier); a disk hit "
            "also refills dram")
        self._m_evictions = reg.counter(
            "engine_tier_evictions_total", "payloads dropped off a "
            "tier's cold end (label tier) — the working set outran "
            "the tier budget")
        self._m_corrupt = reg.counter(
            "engine_tier_corrupt_total", "disk-tier files quarantined "
            "(bad magic, checksum mismatch, short read, stamp "
            "mismatch at adoption) — each one served as a miss, "
            "never an exception")
        for t in TIERS:
            self._m_bytes.set(0, tier=t)
            self._m_entries.set(0, tier=t)
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
            self._scan_disk()

    # -- introspection -----------------------------------------------------
    @property
    def dram_used(self) -> int:
        return self._dram_used

    @property
    def disk_used(self) -> int:
        return self._disk_used

    def tier_of(self, digest: bytes) -> Optional[str]:
        if digest in self._dram:
            return "dram"
        if digest in self._disk:
            return "disk"
        return None

    def __contains__(self, digest) -> bool:
        return self.tier_of(digest) is not None

    def digests(self, limit: Optional[int] = None) -> Dict[str, List[str]]:
        """Hex digests resident per tier, NEWEST first (the warm end is
        what a fleet directory wants when the listing is capped)."""
        out = {}
        for t, d in (("dram", self._dram), ("disk", self._disk)):
            hexes = [k.hex() for k in reversed(d)]
            out[t] = hexes[:limit] if limit else hexes
        return out

    def health(self, digest_limit: int = 512) -> dict:
        """The ``/healthz`` ``tiers`` section: occupancy + a capped
        newest-first digest listing per tier — what the router scrapes
        into its fleet-global cache directory."""
        return {
            "dram": {"bytes": self._dram_used,
                     "capacity_bytes": self.dram_bytes,
                     "entries": len(self._dram)},
            "disk": {"bytes": self._disk_used,
                     "capacity_bytes": self.disk_bytes,
                     "entries": len(self._disk)},
            "eviction_epoch": self.eviction_epoch,
            "digests": self.digests(digest_limit)}

    # -- demotion ----------------------------------------------------------
    def put(self, digest: bytes, payload: bytes):
        """Demote one block payload into the hierarchy (DRAM first).
        A payload larger than every tier budget is dropped outright; a
        digest already resident just refreshes its recency."""
        digest = bytes(digest)
        if digest in self._dram:
            self._dram.move_to_end(digest)
            return
        if digest in self._disk:
            self._disk.move_to_end(digest)
            return
        if self.dram_bytes >= len(payload):
            self._dram[digest] = payload
            self._dram_used += len(payload)
            self._m_demotions.inc(tier="dram")
            while self._dram_used > self.dram_bytes:
                old, old_payload = self._dram.popitem(last=False)
                self._dram_used -= len(old_payload)
                self._spill_to_disk(old, old_payload)
        else:
            self._spill_to_disk(digest, payload, direct=True)
        self._sync_gauges()

    def _spill_to_disk(self, digest: bytes, payload: bytes,
                       direct: bool = False):
        if self.disk_dir is None or self.disk_bytes < len(payload):
            self._m_evictions.inc(tier="dram" if not direct else "disk")
            self.eviction_epoch += 1
            return
        path = self._path(digest)
        tmp = os.path.join(self.disk_dir,
                           f".tmp-{digest.hex()}.{os.getpid()}")
        blob = _FILE_MAGIC + _payload_sum(payload) + payload
        try:
            # no fsync: this is a CACHE, not a checkpoint — a torn
            # file after an OS crash reads back as a checksum miss
            # (quarantined, recomputed), so durability buys nothing
            # and the spill sits on the alloc critical path
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)      # atomic publish: a reader (or a
            #                            restart scan) sees the whole
            #                            file or nothing
        except OSError:
            # a full/readonly disk degrades the tier to a drop, never
            # an exception on the eviction path
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self._m_evictions.inc(tier="disk")
            self.eviction_epoch += 1
            return
        if digest in self._disk:       # republish refreshed the bytes
            self._disk_used -= self._disk.pop(digest)
        self._disk[digest] = len(blob)
        self._disk_used += len(blob)
        self._m_demotions.inc(tier="disk")
        while self._disk_used > self.disk_bytes:
            old, size = self._disk.popitem(last=False)
            self._disk_used -= size
            try:
                os.unlink(self._path(old))
            except OSError:
                pass
            self._m_evictions.inc(tier="disk")
            if old not in self._dram:
                self.eviction_epoch += 1

    # -- promotion ---------------------------------------------------------
    def get(self, digest: bytes) -> Optional[Tuple[str, bytes]]:
        """``(tier, payload)`` for a resident digest, else None. A disk
        hit verifies the checksum (corrupt/truncated → quarantined,
        counted, miss) and refills the DRAM tier so a hot chain climbs
        back up the hierarchy."""
        digest = bytes(digest)
        payload = self._dram.get(digest)
        if payload is not None:
            self._dram.move_to_end(digest)
            self._m_promotions.inc(tier="dram")
            return "dram", payload
        if digest not in self._disk:
            return None
        payload = self._read_disk(digest)
        if payload is None:
            return None
        self._m_promotions.inc(tier="disk")
        if self.dram_bytes >= len(payload):
            # refill DRAM WITHOUT re-demoting the cascade back onto
            # this same digest's disk slot (it stays resident on disk;
            # double-residency is fine — tier_of reports the fast one)
            self._dram[digest] = payload
            self._dram_used += len(payload)
            while self._dram_used > self.dram_bytes:
                old, old_payload = self._dram.popitem(last=False)
                self._dram_used -= len(old_payload)
                if old != digest:
                    self._spill_to_disk(old, old_payload)
            self._sync_gauges()
        return "disk", payload

    def _read_disk(self, digest: bytes) -> Optional[bytes]:
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self._drop_disk(digest)
            return None
        head = len(_FILE_MAGIC) + _SUM_BYTES
        if (len(blob) < head or blob[:len(_FILE_MAGIC)] != _FILE_MAGIC
                or _payload_sum(blob[head:])
                != blob[len(_FILE_MAGIC):head]):
            self.quarantine(digest)
            return None
        return blob[head:]

    def _drop_disk(self, digest: bytes):
        size = self._disk.pop(digest, None)
        if size is not None:
            self._disk_used -= size
            if digest not in self._dram:
                self.eviction_epoch += 1
            self._sync_gauges()

    def quarantine(self, digest: bytes):
        """Remove ``digest`` from the store and park its disk file (if
        any) under ``*.corrupt`` — called on checksum failure here and
        by the engine on a stamp mismatch at adoption. Counted; never
        raises."""
        digest = bytes(digest)
        payload = self._dram.pop(digest, None)
        if payload is not None:
            self._dram_used -= len(payload)
            if digest not in self._disk:
                self.eviction_epoch += 1
        if digest in self._disk:
            self._drop_disk(digest)
            path = self._path(digest)
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
        elif payload is None:
            return                     # nothing resident: nothing to count
        self._m_corrupt.inc()
        self._sync_gauges()

    # -- disk scan / bookkeeping -------------------------------------------
    def _path(self, digest: bytes) -> str:
        return os.path.join(self.disk_dir, digest.hex() + ".kv")

    def _scan_disk(self):
        """Re-adopt a previous process's published files (oldest first
        so LRU age survives the restart); temp files from a killed
        writer are deleted, quarantined files ignored. Content is NOT
        verified here — the checksum runs at get(), so a torn file
        costs nothing until (and unless) its digest is asked for."""
        entries = []
        for fn in os.listdir(self.disk_dir):
            path = os.path.join(self.disk_dir, fn)
            if fn.startswith(".tmp-"):
                try:
                    os.unlink(path)    # a writer died mid-publish; the
                except OSError:        # temp was never visible to get()
                    pass
                continue
            if not fn.endswith(".kv"):
                continue
            try:
                digest = bytes.fromhex(fn[:-3])
                st = os.stat(path)
            except (ValueError, OSError):
                continue
            entries.append((st.st_mtime, digest, st.st_size))
        budget_ok = []
        total = 0
        for mtime, digest, size in sorted(entries, reverse=True):
            # newest first under the budget; anything past it is stale
            # spill from a larger previous configuration
            if total + size > self.disk_bytes:
                try:
                    os.unlink(self._path(digest))
                except OSError:
                    pass
                continue
            total += size
            budget_ok.append((mtime, digest, size))
        for _, digest, size in sorted(budget_ok):
            self._disk[digest] = size
            self._disk_used += size
        self._sync_gauges()

    def _sync_gauges(self):
        self._m_bytes.set(self._dram_used, tier="dram")
        self._m_bytes.set(self._disk_used, tier="disk")
        self._m_entries.set(len(self._dram), tier="dram")
        self._m_entries.set(len(self._disk), tier="disk")

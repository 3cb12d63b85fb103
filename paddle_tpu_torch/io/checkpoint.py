"""Checkpoint save/resume (counterpart of ``paddle_tpu/io/checkpoint.py``;
the same files, so a checkpoint written by either package loads in the
other).

Reference: paddle/trainer/ParamUtil.cpp (per-pass dirs save_dir/pass-%05d,
--init_model_path/--start_pass resume) + Go pserver disk checkpoints with
checksum + etcd meta (go/pserver/service.go:119-174).

One directory per checkpoint holding a numpy .npz per tree (params /
optimizer state / model state; '/'-joined keys, list and tuple items as
``__<i>``, bf16 leaves as raw 2-byte words) + a JSON manifest with the
step counter and an md5 per file (the Go pserver's integrity scheme),
written atomically via tempdir+rename. Checksums are computed in
bounded-memory chunks.

- ``AsyncCheckpointer`` — ``save()`` takes a real copy of every leaf
  (the trainer updates parameters IN PLACE, and a CPU tensor's
  ``numpy()`` would alias them): a CPU leaf is cloned, a CUDA leaf is
  copied into pinned host memory with ``non_blocking=True`` on the
  current stream (ordered after the step that wrote it and before the
  next), and an event recorded after those copies is what the worker
  thread waits on before it reads the host buffers. Serialization,
  checksums, IO and pruning run on the worker thread.
- ``save_checkpoint(..., process_index/process_count)`` — the
  multi-process file layout: each process writes its own npz
  (``params.p{K}.npz``) and manifest; load merges every process file
  present, reassembling ``@@i`` shard entries from their index metadata.
  A sharded tensor (a ``DTensor`` of the parallel tier, or an array
  exposing ``addressable_shards``) is written as this process's shards
  with their index metadata; a parallel trainer's ``AsyncCheckpointer``
  has each rank write its own file set.

Crash-consistent commit protocol: every file is written to a hidden
tempdir, fsync'd, and published atomically — single-process by one
``os.rename`` of the whole dir (re-saving an existing step renames the
old dir aside first), multi-process by per-file ``os.replace`` with the
manifest moved LAST (the manifest's presence is the commit point), then
the parent directory is fsync'd. A save killed at ANY instant therefore
leaves an intact restorable checkpoint behind; ``latest_checkpoint``
additionally validates completeness (every process's manifest present)
so a torn dir is skipped in favour of the previous intact step.
``fence=`` (a callable) gates the commit: when it returns False at
publish time the save aborts with ``CheckpointFencedError`` and nothing
is published. Chaos hooks (``runtime/chaos.py`` site ``checkpoint``,
phases pre_write/pre_manifest/pre_commit/mid_commit) let tests
interrupt each window.
"""

import hashlib
import json
import os
import pickle
import queue
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class CheckpointFencedError(RuntimeError):
    """A save's commit fence rejected the publish — the writer belongs
    to a superseded coordination epoch and must not commit."""


def _chaos(phase: str, step: int):
    """Checkpoint-site chaos hook (no-op unless PADDLE_TPU_CHAOS set)."""
    if os.environ.get("PADDLE_TPU_CHAOS"):
        from paddle_tpu_torch.runtime import chaos
        chaos.maybe_trigger("checkpoint", phase=phase, step=step)


def _fsync_path(path):
    """fsync one file or directory; directory fsync makes the rename
    itself durable. Best-effort: some filesystems refuse dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dict/list/tuple trees -> {'/'-joined path: leaf}, list and
    tuple items as ``__<i>``; leaves are returned as they are."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _host_array(leaf) -> np.ndarray:
    """A host leaf as the array ``np.savez`` writes: bf16 as raw 2-byte
    words (``|V2``, as the JAX package's bfloat16 arrays land in an
    npz), every other dtype as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


class _HostShards:
    """A sharded leaf's host copy: this process's [(index slices, host
    tensor)] and the whole array's shape (``_local_shards`` reads it)."""

    def __init__(self, shards, shape):
        self.shards, self.shape = shards, tuple(shape)


def _dtensor_index(t):
    from paddle_tpu_torch.parallel import spmd
    lay = spmd.Layout(t.device_mesh, spmd.spec_of(t))
    return lay.local_slices(tuple(t.shape))


def _snapshot(tree, parts: Optional[Dict[str, float]] = None):
    """({path: host copy}, [CUDA events]): a copy of every leaf taken
    NOW, so later in-place updates cannot reach it. CPU tensors are
    cloned; CUDA tensors are copied into pinned host memory on their
    device's current stream without blocking, and the events recorded
    after those copies must complete before the host copies are read.
    ``parts`` (when given) gains the seconds spent allocating the pinned
    copies (``pin_alloc_s``) and the bytes copied off the device
    (``device_bytes``)."""
    out, devices = {}, []
    alloc_s, nbytes = 0.0, 0
    for k, v in _flatten(tree).items():
        shard_of = None
        if type(v).__name__ == "DTensor":
            shard_of = (_dtensor_index(v), tuple(v.shape))
            v = v.to_local()
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.device.type == "cuda":
                t0 = time.perf_counter()
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                alloc_s += time.perf_counter() - t0
                nbytes += v.numel() * v.element_size()
                host.copy_(v, non_blocking=True)
                if v.device not in devices:
                    devices.append(v.device)
                out[k] = host
            else:
                out[k] = v.clone()
            if shard_of is not None:
                out[k] = _HostShards([(shard_of[0], out[k])], shard_of[1])
        else:
            out[k] = np.array(v, copy=True)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    if parts is not None:
        parts["pin_alloc_s"] = parts.get("pin_alloc_s", 0.0) + alloc_s
        parts["device_bytes"] = parts.get("device_bytes", 0) + nbytes
    return out, events


def _leaf_like(arr: np.ndarray, like):
    """A loaded array as a leaf shaped by the template leaf ``like``: a
    tensor on ``like``'s device in ``like``'s dtype when ``like`` is a
    tensor (``|V2`` words read as bf16), else a CPU tensor as stored."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _unflatten_into(flat: Dict[str, np.ndarray], tree):
    """Rebuild values in the structure of `tree` from flat paths."""
    def build(subtree, prefix):
        if isinstance(subtree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in subtree.items()}
        if isinstance(subtree, (list, tuple)):
            vals = [build(v, f"{prefix}__{i}/") for i, v in enumerate(subtree)]
            return type(subtree)(vals)
        return _leaf_like(flat[prefix.rstrip("/")], subtree)
    return build(tree, "")


def _file_md5(path):
    """Chunked digest — npz writing seeks (zip headers), so a write-through
    hash cannot work; a 1MB-chunk re-read keeps memory bounded (the old
    path read whole files into memory)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _local_shards(arr):
    """[(index slices, shard)] of what this process holds of a sharded
    leaf (a DTensor's local shard, a snapshot's ``_HostShards``, or an
    array's ``addressable_shards``, replicas written once); a single
    [(None, arr)] for a whole tensor or array."""
    if isinstance(arr, _HostShards):
        return arr.shards
    if type(arr).__name__ == "DTensor":
        return [(_dtensor_index(arr), arr.to_local())]
    shards = getattr(arr, "addressable_shards", None)
    fully_local = getattr(arr, "is_fully_addressable", True)
    if shards is None or (fully_local and len(shards) <= 1):
        return [(None, arr)]
    seen, out = set(), []
    for sh in shards:
        key = tuple((sl.start, sl.stop, sl.step) for sl in sh.index)
        if key in seen:
            continue            # replicated across devices: write once
        seen.add(key)
        out.append((sh.index, sh.data))
    return out


def _write_tree(tmp, fname, tree, manifest, sharded, host_trees=None):
    flat = host_trees[fname] if host_trees else _flatten(tree)
    path = os.path.join(tmp, fname + ".npz")
    entries, index_meta = {}, {}
    for key, arr in flat.items():
        if not sharded and not isinstance(arr, _HostShards) \
                and type(arr).__name__ != "DTensor":
            entries[key] = _host_array(arr)
            continue
        for i, (idx, shard) in enumerate(_local_shards(arr)):
            if idx is None:
                entries[key] = _host_array(shard)
            else:
                entries[f"{key}@@{i}"] = _host_array(shard)
                index_meta.setdefault(key, {})[str(i)] = [
                    [sl.start, sl.stop] for sl in idx]
    with open(path, "wb") as raw:
        np.savez(raw, **entries)
    manifest["files"][fname] = _file_md5(path)
    if index_meta:
        manifest.setdefault("shards", {})[fname] = {
            "full_shapes": {k: [int(n) for n in np.shape(v)]
                            for k, v in flat.items()},
            "index": index_meta}


#: incomplete dirs younger than this are presumed to be a peer host's
#: still-publishing save, not a corpse, and are never pruned
_TORN_PRUNE_GRACE_S = 900.0


def _prune_old(save_dir, keep):
    import shutil
    import time as _time
    names = sorted(d for d in os.listdir(save_dir) if d.startswith("ckpt-"))
    if not names:
        return
    # the keep budget counts COMPLETE checkpoints only: torn dirs (a
    # host died mid-publish) must not evict restorable state — else a
    # run of torn saves would leave nothing to restore. Torn dirs are
    # collected only once their mtime is stale past the grace (a slower
    # peer may still be publishing into a recent one — its os.replace
    # must not race a rmtree), and the newest entry is always spared.
    now = _time.time()
    complete, stale_torn = [], []
    for d in names:
        p = os.path.join(save_dir, d)
        if is_complete(p):
            complete.append(d)
        else:
            try:
                age = now - os.path.getmtime(p)
            except OSError:
                continue
            if age > _TORN_PRUNE_GRACE_S:
                stale_torn.append(d)
    keep_set = set(complete[-keep:])
    keep_set.add(names[-1])
    for d in names:
        if d in keep_set:
            continue
        if d in complete or d in stale_torn:
            shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)


def _write_single(save_dir, step, trees, keep, host_trees=None,
                  sharded=False, process_index=0, process_count=1,
                  blobs=None, meta=None, fence=None):
    """Shared atomic-write core for save_checkpoint and AsyncCheckpointer.
    ``trees``: {fname: pytree} (ignored per-entry when host_trees carries
    the pre-flattened host copy). ``blobs``: {name: bytes} opaque
    payloads (the pipeline's pickled stream position) written verbatim
    as ``<name><suffix>.pkl`` with their checksum in the manifest.
    ``meta``: JSON-able layout metadata (e.g. the ZeRO sharding layout
    the state was trained under) stored in the manifest — restores onto
    a different mesh read it to know a reshard is happening.
    ``fence``: callable checked immediately before the publish (and
    again at the multi-host manifest move, the per-process commit
    point); False aborts with ``CheckpointFencedError``. A deposition
    landing INSIDE the final rename syscall can still commit — the
    window is one rename wide, the same bounded guarantee as the
    master's snapshot fencing (runtime/supervisor.py epoch fencing)."""
    name = f"ckpt-{step:08d}"
    final = os.path.join(save_dir, name)
    os.makedirs(save_dir, exist_ok=True)
    suffix = f".p{process_index}" if process_count > 1 else ""
    tmp = tempfile.mkdtemp(dir=save_dir, prefix=".tmp-" + name + suffix)
    try:
        _chaos("pre_write", step)
        manifest = {"step": int(step), "files": {},
                    "process_index": process_index,
                    "process_count": process_count}
        # stamp the gang incarnation (elastic env contract) so a dir
        # holding pieces from TWO save attempts — torn, restarted,
        # re-torn at the same step — is judged incomplete instead of
        # silently merging shards across incarnations
        if os.environ.get("PADDLE_ELASTIC_EPOCH"):
            try:
                manifest["save_epoch"] = int(
                    os.environ["PADDLE_ELASTIC_EPOCH"])
            except ValueError:
                pass
        if meta is not None:
            manifest["meta"] = meta
        for base, tree in trees.items():
            if tree is None and not (host_trees and base in host_trees):
                continue
            _write_tree(tmp, base + suffix, tree, manifest, sharded,
                        host_trees={base + suffix: host_trees[base]}
                        if host_trees else None)
        for bname, data in (blobs or {}).items():
            bpath = os.path.join(tmp, bname + suffix + ".pkl")
            with open(bpath, "wb") as f:
                f.write(data)
            manifest.setdefault("blobs", {})[bname + suffix] = \
                _file_md5(bpath)
        _chaos("pre_manifest", step)
        with open(os.path.join(tmp, f"manifest{suffix}.json"), "w") as f:
            json.dump(manifest, f)
        # durability before visibility: every byte reaches disk while the
        # checkpoint is still invisible to readers, so the publish below
        # can never expose data the kernel might lose in a host crash
        for fn in os.listdir(tmp):
            _fsync_path(os.path.join(tmp, fn))
        _fsync_path(tmp)
        _chaos("pre_commit", step)
        if fence is not None and not fence():
            raise CheckpointFencedError(
                f"checkpoint step {step} not committed: fence rejected "
                f"the publish (superseded coordination epoch?)")
        if process_count > 1:
            # multi-host: move our files into the shared dir; process 0
            # owns directory lifecycle, others only add their piece. The
            # manifest moves LAST — its presence is this process's commit
            # point, so a reader that sees all manifests sees all data
            # files too (and latest_checkpoint skips dirs missing any
            # process's manifest).
            os.makedirs(final, exist_ok=True)
            if process_index == 0:
                # re-saving into a dir a LARGER previous gang tore
                # mid-publish (elastic shrink): stale .pK pieces with
                # K >= the new process_count have no writer anymore and
                # would make completeness unsatisfiable forever — drop
                # them so the dir converges to the new cohort
                import re
                for fn in os.listdir(final):
                    m = re.search(r"\.p(\d+)\.", fn)
                    if m and int(m.group(1)) >= process_count:
                        try:
                            os.unlink(os.path.join(final, fn))
                        except OSError:
                            pass
            manifest_fn = f"manifest{suffix}.json"
            for fn in sorted(os.listdir(tmp),
                             key=lambda n: n == manifest_fn):
                if fn == manifest_fn:
                    _chaos("mid_commit", step)
                    # re-check the fence AT the commit point: the
                    # manifest move is what makes this piece visible,
                    # so a deposition during the data-file moves still
                    # aborts (the residual window is one rename wide —
                    # the same bounded guarantee as the master's
                    # snapshot fencing)
                    if fence is not None and not fence():
                        raise CheckpointFencedError(
                            f"checkpoint step {step} not committed: "
                            f"fence rejected the manifest publish")
                os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
            # the renames INTO final are directory metadata of final
            # itself — without this fsync the manifest entry can vanish
            # in a host crash after the 'commit'
            _fsync_path(final)
            os.rmdir(tmp)
        else:
            import shutil
            aside = None
            if os.path.exists(final):
                # re-saving an existing step (restore + re-executed
                # window): move the old dir ASIDE by rename — the
                # exposure is one rename syscall, not an rmtree's
                # seconds — publish, then collect the corpse
                aside = f"{tmp}.old"
                os.rename(final, aside)
            os.rename(tmp, final)
            if aside is not None:
                shutil.rmtree(aside, ignore_errors=True)
        _fsync_path(save_dir)
    except BaseException:
        # an aborted save must not strand its tempdir as save_dir litter
        # (the chaos kill/hang paths never reach here — their leftover
        # .tmp-* dirs are invisible to latest_checkpoint by prefix)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if process_index == 0:
        _prune_old(save_dir, keep)
    return final


def save_checkpoint(save_dir: str, step: int, params: Dict,
                    opt_state=None, model_state=None, keep: int = 3,
                    process_index: int = 0, process_count: int = 1,
                    sharded: bool = False, pipeline_state=None,
                    meta=None, fence=None):
    """Write checkpoint 'pass-%05d' style dir; prunes old ones.

    With ``sharded=True`` (or process_count>1) each array entry stores this
    process's addressable shards plus their index metadata — the multi-host
    layout where every host writes only what it owns.

    ``pipeline_state``: the input pipeline's ``state_dict()`` (source
    cursor, shuffle RNG + buffer, batch counter) — persisted next to the
    model so a restore continues the data stream mid-epoch on the exact
    next batch (``load_pipeline_state``)."""
    blobs = None
    if pipeline_state is not None:
        blobs = {"pipeline": pickle.dumps(pipeline_state, protocol=4)}
    return _write_single(
        save_dir, step,
        {"params": params, "opt_state": opt_state,
         "model_state": model_state},
        keep, sharded=sharded or process_count > 1,
        process_index=process_index, process_count=process_count,
        blobs=blobs, meta=meta, fence=fence)


def checkpoint_meta(path: str) -> Optional[dict]:
    """The layout metadata stored with a checkpoint (``meta=`` at save
    time; e.g. the ZeRO optimizer-state layout) — None for checkpoints
    written without any, so every older checkpoint stays loadable."""
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return None
    for fn in names:
        if fn.startswith("manifest") and fn.endswith(".json"):
            with open(os.path.join(path, fn)) as f:
                manifest = json.load(f)
            if manifest.get("meta") is not None:
                return manifest["meta"]
    return None


def _read_manifests(path):
    """Every manifest*.json in a checkpoint dir, parsed (may be [])."""
    manifests = []
    for fn in sorted(os.listdir(path)):
        if fn.startswith("manifest") and fn.endswith(".json"):
            with open(os.path.join(path, fn)) as f:
                manifests.append(json.load(f))
    return manifests


def _check_complete(manifests, path):
    """Raise IOError unless every participating process's manifest is
    present — a partial multi-host checkpoint (a host died mid-save)
    must not load: _load_group would silently zero-fill the missing
    hosts' shards."""
    if not manifests:
        raise IOError(f"no manifest in checkpoint dir {path}")
    want = max(m.get("process_count", 1) for m in manifests)
    have = sorted(m.get("process_index", 0) for m in manifests)
    if have != list(range(want)):
        raise IOError(
            f"incomplete checkpoint {path}: have manifests for processes "
            f"{have} of {want} — a host's save did not finish")
    # all pieces must come from ONE save incarnation: a torn dir
    # re-written by a restarted gang can transiently hold old-epoch and
    # new-epoch manifests that happen to cover every index. An
    # UNSTAMPED manifest (no elastic env) is a wildcard — a host that
    # lost the env var must not brick an otherwise consistent save.
    epochs = {m.get("save_epoch") for m in manifests} - {None}
    if len(epochs) > 1:
        raise IOError(
            f"incomplete checkpoint {path}: manifests from mixed save "
            f"incarnations {sorted(epochs)}")


def is_complete(path: str) -> bool:
    """True when the checkpoint dir is a committed, loadable unit (all
    manifests present and parseable). Cheap: reads only the manifests."""
    try:
        _check_complete(_read_manifests(path), path)
        return True
    except (OSError, ValueError, KeyError):
        return False


def latest_checkpoint(save_dir: str,
                      complete_only: bool = True) -> Optional[str]:
    """Newest COMMITTED checkpoint dir (or None). A save interrupted
    mid-publish (multi-host manifest-last window) leaves a torn
    ``ckpt-*`` dir; with ``complete_only`` (the default) such dirs are
    skipped so a restore falls back to the previous intact step instead
    of dying on the torn one — the crash-consistency contract the
    elastic supervisor restarts depend on."""
    if not os.path.isdir(save_dir):
        return None
    for d in sorted((d for d in os.listdir(save_dir)
                     if d.startswith("ckpt-")), reverse=True):
        path = os.path.join(save_dir, d)
        if not complete_only or is_complete(path):
            return path
    return None


def _verify_file(fpath, want):
    if _file_md5(fpath) != want:
        raise IOError(f"checkpoint checksum mismatch: {fpath}")


def _load_group(path, base, manifests, verify):
    """Merge a logical tree ('params') across every process file present,
    reassembling sharded entries from their index metadata."""
    flat, pending = {}, {}
    for manifest in manifests:
        suffix = (f".p{manifest['process_index']}"
                  if manifest.get("process_count", 1) > 1 else "")
        fname = base + suffix
        if fname not in manifest["files"]:
            return None
        fpath = os.path.join(path, fname + ".npz")
        if verify:
            _verify_file(fpath, manifest["files"][fname])
        data = dict(np.load(fpath))
        shard_meta = manifest.get("shards", {}).get(fname, {})
        index = shard_meta.get("index", {})
        shapes = shard_meta.get("full_shapes", {})
        for key, arr in data.items():
            if "@@" not in key:
                flat[key] = arr
                continue
            base_key, i = key.rsplit("@@", 1)
            buf = pending.get(base_key)
            if buf is None:
                buf = pending[base_key] = np.zeros(
                    shapes[base_key], arr.dtype)
            slices = tuple(slice(a, b) for a, b in index[base_key][i])
            buf[slices] = arr
    flat.update(pending)
    return flat


def load_checkpoint(path: str, params: Dict, opt_state=None, model_state=None,
                    verify: bool = True):
    """Load into the *structure* of the given trees; returns
    (step, params, opt_state, model_state). Each tensor leaf comes back
    on the device of the template leaf in its place, in that leaf's
    dtype. Handles both single-process checkpoints and the multi-process
    per-process shard layout (merges every manifest*.json present)."""
    manifests = _read_manifests(path)
    _check_complete(manifests, path)
    out = []
    for base, tree in (("params", params), ("opt_state", opt_state),
                       ("model_state", model_state)):
        if tree is None:
            out.append(tree)
            continue
        flat = _load_group(path, base, manifests, verify)
        out.append(_unflatten_into(flat, tree) if flat is not None else tree)
    return (manifests[0]["step"], *out)


def load_pipeline_state(path: str, process_index: int = 0,
                        verify: bool = True) -> Optional[dict]:
    """Read the input-pipeline stream position saved with this
    checkpoint (or None for checkpoints written without one — every
    pre-pipeline checkpoint stays loadable)."""
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return None
    for fn in names:
        if not (fn.startswith("manifest") and fn.endswith(".json")):
            continue
        with open(os.path.join(path, fn)) as f:
            manifest = json.load(f)
        if manifest.get("process_index", 0) != process_index:
            continue
        for bname, digest in manifest.get("blobs", {}).items():
            if bname == "pipeline" or bname.startswith("pipeline.p"):
                bpath = os.path.join(path, bname + ".pkl")
                if verify:
                    _verify_file(bpath, digest)
                with open(bpath, "rb") as f:
                    return pickle.load(f)
    return None


class AsyncCheckpointer:
    """Asynchronous checkpoint writer.

    ``save()`` takes a real copy of the trees (``_snapshot``: CPU leaves
    cloned, CUDA leaves copied to pinned host memory on the current
    stream behind an event) and enqueues serialization + checksum +
    disk IO + pruning on the ``checkpoint-writer`` thread, which waits
    for the event before it reads the copies. Training resumes
    immediately; call ``wait()`` before reading the directory or
    exiting. ``write_seconds`` holds the worker's wall time per save,
    ``save_parts`` what each ``save()`` spent on the caller's thread."""

    def __init__(self, save_dir: str, keep: int = 3, max_pending: int = 2,
                 fence=None, process_index: int = 0,
                 process_count: int = 1):
        """``fence``: commit gate checked by the worker thread right
        before each publish (see ``_write_single``) — a fenced save
        surfaces as ``CheckpointFencedError`` on the next save()/wait().
        ``process_index`` / ``process_count``: the multi-process layout
        (each process writes its own shards and manifest)."""
        self.save_dir = save_dir
        self.keep = keep
        self.fence = fence
        self.process_index, self.process_count = process_index, process_count
        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self.write_seconds: List[float] = []
        self.save_parts: List[Dict[str, float]] = []
        self._worker = threading.Thread(target=self._run,
                                        name="checkpoint-writer",
                                        daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_trees, events, blobs, meta = item
            try:
                t0 = time.perf_counter()
                for ev in events:
                    ev.synchronize()     # the device->host copies landed
                self._write(step, host_trees, blobs, meta)
                self.write_seconds.append(time.perf_counter() - t0)
            except Exception as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step, host_trees, blobs=None, meta=None):
        _write_single(self.save_dir, step,
                      {base: None for base in host_trees}, self.keep,
                      host_trees=host_trees, blobs=blobs, meta=meta,
                      fence=self.fence, sharded=self.process_count > 1,
                      process_index=self.process_index,
                      process_count=self.process_count)

    def save(self, step: int, params: Dict, opt_state=None,
             model_state=None, pipeline_state=None, meta=None):
        """``pipeline_state`` is pickled HERE, on the caller's thread —
        the pipeline keeps mutating as training continues, so the worker
        must serialize a frozen snapshot, not a live reference.
        ``meta``: JSON-able layout metadata for the manifest (see
        ``save_checkpoint``).

        Returns the save's parts, also appended to ``save_parts``: the
        seconds of the trees' snapshot (``snapshot_s``, of which
        ``pin_alloc_s`` allocated the pinned host copies), of pickling
        the pipeline state (``pickle_s``) and of handing the save to the
        writer (``enqueue_s``: it waits while ``max_pending`` saves are
        queued), with the bytes copied off the device
        (``device_bytes``) and the pickled state's (``pipeline_bytes``)."""
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        parts = {"pin_alloc_s": 0.0, "device_bytes": 0}
        t0 = time.perf_counter()
        host_trees, events = {}, []
        for fname, tree in (("params", params), ("opt_state", opt_state),
                            ("model_state", model_state)):
            if tree is not None:
                host_trees[fname], evs = _snapshot(tree, parts)
                events += evs
        t1 = time.perf_counter()
        blobs = None
        if pipeline_state is not None:
            blobs = {"pipeline": pickle.dumps(pipeline_state, protocol=4)}
        t2 = time.perf_counter()
        self._q.put((int(step), host_trees, events, blobs, meta))
        parts.update(snapshot_s=t1 - t0, pickle_s=t2 - t1,
                     enqueue_s=time.perf_counter() - t2,
                     pipeline_bytes=len(blobs["pipeline"]) if blobs else 0)
        self.save_parts.append(parts)
        return parts

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        try:
            self.wait()
        finally:
            # shut the worker down even when wait() surfaces a write error
            self._q.put(None)
            self._worker.join(timeout=10)

"""The LM serving artifact (counterpart of ``paddle_tpu/io/lm_serving.py``):
int8 serving weights, and every artifact format the JAX package writes:

- v1: the lockstep pair (``LMServer.generate``: batched prefill, then
  lockstep decode steps, host-side sampling);
- v2: v1 with int8 weights (``quantize_lm_params``);
- v3: v1/v2 plus the row-arena slot engine (``LMServer.engine()`` is a
  ``serving.DecodeEngine``);
- v4: the paged engine instead (a ``PagedDecodeEngine``);
- v5: v4 with a draft model (a ``SpecDecodeEngine``).

An artifact is one tar: ``meta.json`` (the config, the shapes and engine
geometry, the format number), ``params.npz`` (the parameter tree,
'/'-joined paths) and, for format v5, ``draft_params.npz`` (the draft
model). The JAX package also packs compiled XLA modules (``*.bin``);
they cannot run here, so :func:`load_lm_artifact` ignores them and the
port runs its own step functions and programs at the stamped shapes and
geometry. The port's :func:`save_lm_artifact` writes weights and meta
only, in the same member layout and format numbers.

A bfloat16 leaf rides in an ``.npz`` as raw 2-byte words (numpy's
``|V2``, which is how an ``ml_dtypes.bfloat16`` array saves): the
loader takes the words as bf16 and the saver writes them so, with no
``ml_dtypes``.
"""

import dataclasses
import io as _io
import json
import tarfile
import time
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes, place
from paddle_tpu_torch.io.checkpoint import (  # shared tree walk
    _flatten, _host_array)
from paddle_tpu_torch.observe import costs as _costs
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.ops import q8

FORMAT_VERSION = 5      # the newest format this loader reads
POOL_LAYOUT = "head_major"

# JAX config fields the serving port does not read; each must hold its
# JAX default (the port refuses ring attention itself)
_JAX_ONLY_FIELDS = {"cp_mode": "ring", "use_flash_attention": False}

# the big matmul weights, each with the axis its consumer contracts over
# (the scale's reduce axis): blocks.* are [L, in, out] (axis -2); embed
# [V, D] doubles as the vocab head contracting over D (axis -1), so an
# embedding row gather dequantizes with its row's scale
_W8_LEAVES = {("blocks", "qkv"): -2, ("blocks", "attn_out"): -2,
              ("blocks", "mlp_in"): -2, ("blocks", "mlp_out"): -2,
              ("embed",): -1}

def _fp32(a, where: str) -> torch.Tensor:
    """An fp32 leaf as a tensor; any other dtype raises."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.float32:
            raise ValueError(f"quantize_lm_params: {where} is {a.dtype}; "
                             f"it quantizes the fp32 tree (quantizing "
                             f"rounded weights gives other bytes)")
        return a.detach()
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise ValueError(f"quantize_lm_params: {where} is {a.dtype}; it "
                         f"quantizes the fp32 tree")
    return torch.from_numpy(a.copy())


def quantize_lm_params(params, device=None):
    """Per-output-channel int8 for the big matmul weights of an fp32
    parameter tree (numpy arrays, ``paddle_tpu``'s tree as numpy, or
    fp32 tensors such as ``init_train_params``'s): each becomes a
    {"q8", "scale"} node; layer norms and the position table stay fp32.
    The result is a serving tree for every serving step and engine
    (``generate``, ``DecodeEngine``, ``PagedDecodeEngine``), on the card
    unless ``device`` says otherwise.

    Only the fp32 tree is accepted: the serving dict of ``init_params``
    holds the matmul weights already rounded to ``cfg.dtype``, and
    quantizing those gives other bytes than ``paddle_tpu`` does. An
    expert tree is refused, as ``paddle_tpu``'s ``_W8_LEAVES`` refuses
    it (its rules name ``mlp_in`` / ``mlp_out``, which an MoE tree does
    not hold, and no expert leaf)."""
    if "moe_w_in" in params.get("blocks", {}):
        raise KeyError("quantize_lm_params: an expert tree has no int8 "
                       "rule (paddle_tpu's _W8_LEAVES name blocks.mlp_in "
                       "and blocks.mlp_out, which it does not hold)")
    device = place.resolve_device(device)
    out = {}
    for name, leaf in params.items():
        if name == "blocks":
            out[name] = {}
            for bname, bleaf in leaf.items():
                t = _fp32(bleaf, f"blocks.{bname}").to(device)
                axis = _W8_LEAVES.get((name, bname))
                out[name][bname] = (q8.quantize_weight(t, axis)
                                    if axis is not None else t.contiguous())
        else:
            t = _fp32(leaf, name).to(device)
            axis = _W8_LEAVES.get((name,))
            out[name] = (q8.quantize_weight(t, axis) if axis is not None
                         else t.contiguous())
    return out


# ---------------------------------------------------------------------------
# the tree and the config as the artifact stores them
# ---------------------------------------------------------------------------


def _unflatten(flat: dict):
    """The nested tree of '/'-joined paths, with no template: dict nodes
    whose keys are all ``__<i>`` were lists."""
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict):
            node = {k: fix(v) for k, v in node.items()}
            if node and all(k.startswith("__") for k in node):
                return [node[f"__{i}"] for i in range(len(node))]
        return node

    return fix(tree)


def _cfg_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = dtypes.name(cfg.dtype)
    return d


def _cfg_from_dict(d: dict):
    """A stamped config (the JAX package's field set, or the port's) as
    the port's ``TransformerConfig``."""
    from paddle_tpu_torch.models.transformer import TransformerConfig
    d = dict(d)
    for name, default in _JAX_ONLY_FIELDS.items():
        value = d.pop(name, default)
        if value != default:
            raise ValueError(f"config {name}={value!r}: the port serves "
                             f"only {name}={default!r}")
    d["dtype"] = dtypes.resolve(d["dtype"])
    return TransformerConfig(**d)


def _leaf_tensor(a: np.ndarray):
    """An ``np.load`` leaf: ``|V2`` words as a bf16 tensor with the same
    words; any other array as it is."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.frombuffer(bytearray(a.tobytes()),
                                dtype=torch.bfloat16).reshape(a.shape)
    return a


def _npz_bytes(tree) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **{k: _host_array(v) for k, v in _flatten(tree).items()})
    return buf.getvalue()


def _npz_tree(blob: bytes):
    with np.load(_io.BytesIO(blob), allow_pickle=False) as z:
        return _unflatten({k: _leaf_tensor(z[k]) for k in z.files})


def _add(tar, name: str, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = int(time.time())
    tar.addfile(info, _io.BytesIO(data))


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_lm_artifact(path: str, params, cfg, *, batch: int,
                     prompt_len: int, cache_len: int,
                     weights_int8: bool = False,
                     engine_buckets=None, engine_paged: bool = False,
                     engine_block_size: int = 16,
                     engine_num_blocks: Optional[int] = None,
                     engine_kv_dtype: Optional[str] = None,
                     engine_draft_params=None, engine_draft_config=None,
                     engine_spec_k: int = 4) -> None:
    """Pack an artifact with the keywords of ``paddle_tpu``'s
    ``save_lm_artifact``, weights and meta only (no compiled modules),
    stamped with the JAX package's format numbers: v1 (plain weights),
    v2 (``weights_int8``), v3 (with ``engine_buckets``: the slot
    engine's prompt buckets, ``batch`` its arena rows), v4
    (``engine_paged=True``: the buckets are chunk buckets, the chunk
    grid their largest) and v5 (with a draft model). ``params`` is a
    tree of tensors or numpy arrays (a serving tree's bf16 leaves are
    stored as raw words, so a load gives them back bit for bit);
    ``weights_int8`` stores the ``quantize_lm_params`` int8 tree of an
    fp32 one (an int8 tree is stored as it is). The JAX checks raise
    the same errors: a quantized pool or a draft needs the paged
    engine."""
    from paddle_tpu_torch.models import transformer
    if cache_len > cfg.max_len:
        raise ValueError(f"cache_len {cache_len} exceeds cfg.max_len "
                         f"{cfg.max_len}")
    if engine_kv_dtype and not engine_paged:
        raise ValueError("engine_kv_dtype needs engine_paged=True (the "
                         "quantized pool is a paged-engine layout)")
    if (engine_draft_params is None) != (engine_draft_config is None):
        raise ValueError("engine_draft_params and engine_draft_config come "
                         "together (the draft model for speculative "
                         "decoding)")
    if engine_draft_params is not None and not engine_paged:
        raise ValueError("engine_draft_params needs engine_paged=True "
                         "(speculative decoding rides the paged block "
                         "table)")
    if engine_draft_config is not None \
            and engine_draft_config.vocab != cfg.vocab:
        raise ValueError(f"draft vocab {engine_draft_config.vocab} != "
                         f"target vocab {cfg.vocab}")
    if engine_paged and not engine_buckets:
        raise ValueError("engine_paged=True needs engine_buckets= (the "
                         "chunk buckets)")
    if weights_int8 and not transformer._blocks_quantized(params):
        params = quantize_lm_params(params, device="cpu")
    weights_int8 = weights_int8 or transformer._blocks_quantized(params)
    meta = {"format_version": 2 if weights_int8 else 1,
            "batch": int(batch), "prompt_len": int(prompt_len),
            "cache_len": int(cache_len), "weights_int8": bool(weights_int8),
            "config": _cfg_to_dict(cfg), "cost_analysis": {}}
    if engine_buckets:
        buckets = sorted({int(b) for b in engine_buckets})
        if buckets[0] < 1 or buckets[-1] > cache_len:
            raise ValueError(f"engine_buckets {buckets} outside "
                             f"[1, cache_len={cache_len}]")
        meta["format_version"] = 3
        meta["engine_buckets"] = buckets
    if engine_paged:
        bs = int(engine_block_size)
        chunk = buckets[-1]
        if bs < 1 or chunk % bs or cache_len % chunk:
            raise ValueError(f"paged export needs block_size {bs} | chunk "
                             f"{chunk} | cache_len {cache_len}")
        pages = cache_len // bs
        meta["format_version"] = 5 if engine_draft_params is not None else 4
        meta["engine_paged"] = {
            "block_size": bs,
            "num_blocks": int(engine_num_blocks
                              if engine_num_blocks is not None
                              else batch * pages),
            "pages_per_slot": pages, "chunk_tokens": chunk,
            "kv_dtype": engine_kv_dtype or "none",
            "pool_layout": POOL_LAYOUT}
    if engine_draft_params is not None:
        meta["engine_spec"] = {"k": int(engine_spec_k),
                               "draft_config": _cfg_to_dict(
                                   engine_draft_config)}
    with tarfile.open(path, "w") as tar:
        _add(tar, "meta.json", json.dumps(meta).encode())
        _add(tar, "params.npz", _npz_bytes(params))
        if engine_draft_params is not None:
            _add(tar, "draft_params.npz", _npz_bytes(engine_draft_params))


def load_lm_artifact(path: str) -> "LMServer":
    """Read an artifact of any format the JAX package writes (v1-v5,
    ``paddle_tpu``'s or the port's): meta, weights and, for v5, the
    draft. Compiled modules are ignored. A newer format raises
    ValueError."""
    with tarfile.open(path, "r") as tar:
        members = {m.name: tar.extractfile(m).read()
                   for m in tar.getmembers()
                   if not m.name.endswith(".bin")}
    meta = json.loads(members["meta.json"])
    version = meta["format_version"]
    if version > FORMAT_VERSION:
        raise ValueError(f"artifact format {version} newer than this "
                         f"loader ({FORMAT_VERSION})")
    draft = members.get("draft_params.npz")
    return LMServer(meta, _npz_tree(members["params.npz"]),
                    _npz_tree(draft) if draft is not None else None)


# decode steps run single-digit ms; prefill tens-to-hundreds
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class LMServer:
    """A loaded artifact: its ``meta``, the weights (``params``, numpy
    arrays and, for bf16 leaves, bf16 tensors) and, for v5, the draft's
    (``draft_params``). :meth:`generate` is the lockstep path at the
    stamped shapes (every format); :meth:`engine` builds the port's
    engine from the stamped geometry (v3-v5). Each server carries its
    own metrics registry: prefill and decode calls, tokens, requests,
    per-phase latency histograms and the decode MFU gauge, as
    ``paddle_tpu``'s server counts them."""

    def __init__(self, meta: dict, params, draft_params=None):
        self.meta = meta
        self.cfg = _cfg_from_dict(meta["config"])
        self.params = params
        self.draft_params = draft_params
        self.engine_buckets = tuple(meta.get("engine_buckets", ()))
        self.cost_analysis = meta.get("cost_analysis", {})
        self._live = {}                 # device -> the weights as tensors
        reg = self.metrics = _metrics.Registry()
        self._m_prefill = reg.counter(
            "lm_prefill_calls_total", "prefill (prompt) passes served")
        self._m_decode = reg.counter(
            "lm_decode_calls_total", "incremental decode steps served")
        self._m_tokens = reg.counter(
            "lm_tokens_generated_total", "tokens sampled across all calls")
        self._m_requests = reg.counter(
            "lm_generate_requests_total", "generate() calls")
        self._m_prefill_s = reg.histogram(
            "lm_prefill_seconds", "prefill latency (device call + sample)",
            buckets=_LATENCY_BUCKETS)
        self._m_decode_s = reg.histogram(
            "lm_decode_seconds", "per-token decode latency (device call + "
            "sample)", buckets=_LATENCY_BUCKETS)
        self._m_mfu = reg.gauge(
            "lm_decode_mfu", "model-FLOPs utilisation of the last decode "
            "step (FLOPs stamped in the artifact, else from the shapes; "
            "0 until a step ran on a card with a declared peak)")
        self._last_generate: Optional[float] = None

    def metrics_text(self) -> str:
        """Prometheus text exposition snapshot of this server's metrics."""
        return self.metrics.render_prometheus()

    def health(self) -> dict:
        """/healthz document: request/token progress of this server."""
        since = (round(time.perf_counter() - self._last_generate, 3)
                 if self._last_generate is not None else None)
        return {"requests": int(self._m_requests.value()),
                "tokens_generated": int(self._m_tokens.value()),
                "decode_steps": int(self._m_decode.value()),
                "seconds_since_request": since,
                "batch": self.meta["batch"],
                "cache_len": self.meta["cache_len"]}

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start an ``observe.health.HealthServer`` over THIS server's
        registry (``/metrics``) and ``health()`` (``/healthz``). Returns
        the server; callers own its ``close()``."""
        from paddle_tpu_torch.observe.health import HealthServer
        return HealthServer(registry=self.metrics, health_fn=self.health,
                            host=host, port=port)

    def _params_on(self, device: torch.device):
        """The weights as the port's serving tensors on ``device``,
        converted once per device."""
        from paddle_tpu_torch.models import transformer
        key = str(device)
        if key not in self._live:
            self._live[key] = transformer.params_from_numpy(
                self.params, self.cfg, device=device)
        return self._live[key]

    def generate(self, prompt: np.ndarray, max_new: int,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 eos_id: Optional[int] = None, *,
                 device=None) -> np.ndarray:
        """Lockstep batch generation at the stamped shapes: prompt
        [batch, prompt_len] int -> [batch, prompt_len + n] int32 numpy,
        ``n <= max_new``. One ``transformer.prefill`` into an arena of
        the stamped ``cache_len``, then ``decode_step`` calls with the
        position carried on the device. Sampling is host-side, as the
        JAX server's: greedy argmax at ``temperature <= 0``, else a
        float64 softmax of ``logits / temperature`` and
        ``RandomState(seed).choice`` per row (``seed=None`` draws fresh
        entropy). ``eos_id`` ends the loop once every row has emitted
        it; rows that finished first pad with it. Runs on the card
        unless ``device="cpu"``."""
        from paddle_tpu_torch.models import transformer
        if max_new < 1:
            raise ValueError(f"generate: max_new must be >= 1, got "
                             f"{max_new}")
        prompt = np.asarray(prompt)
        b, tp = prompt.shape
        if b != self.meta["batch"] or tp != self.meta["prompt_len"]:
            raise ValueError(
                f"artifact exported for batch={self.meta['batch']} "
                f"prompt_len={self.meta['prompt_len']}, got {prompt.shape}")
        if tp + max_new > self.meta["cache_len"]:
            raise ValueError(f"{tp + max_new} positions exceed the "
                             f"exported cache_len {self.meta['cache_len']}")
        device = place.resolve_device(device)
        params = self._params_on(device)
        cfg = self.cfg
        rng = np.random.RandomState(seed)

        def sample(logits: torch.Tensor) -> np.ndarray:
            logits = logits.cpu().numpy()     # the step's one host sync
            if temperature <= 0:
                return logits.argmax(-1).astype(np.int32)
            z = np.asarray(logits, np.float64) / temperature
            z = z - z.max(-1, keepdims=True)
            p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
            return np.asarray([rng.choice(p.shape[-1], p=row)
                               for row in p], np.int32)

        def ids(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        self._m_requests.inc()
        self._last_generate = time.perf_counter()
        stamped = self.cost_analysis.get("decode", {}).get("flops")
        peak = place.peak_flops(device) if device.type == "cuda" else None
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(params, ids(prompt), cfg,
                                            self.meta["cache_len"])
        toks = [sample(logits)]
        self._m_prefill.inc()
        self._m_prefill_s.observe(time.perf_counter() - t0)
        self._m_tokens.inc(b)
        done = (toks[0] == eos_id) if eos_id is not None else None
        # the position advances on the device, as the JAX server carries it
        pos = torch.full((), tp, dtype=torch.int32, device=device)
        for i in range(max_new - 1):
            if eos_id is not None and done.all():
                break               # every row ended: drop the tail steps
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(params, cache,
                                                    ids(toks[-1]), pos, cfg)
            pos = pos + 1
            tok = sample(logits)
            if eos_id is not None:
                tok = np.where(done, eos_id, tok).astype(np.int32)
                done = done | (tok == eos_id)
            toks.append(tok)
            dt = time.perf_counter() - t0
            self._m_decode.inc()
            self._m_decode_s.observe(dt)
            self._m_tokens.inc(b)
            flops = stamped or _costs.decode_step_flops(cfg, [tp + i] * b)
            mfu = _costs.mfu(flops, dt, peak)
            if mfu is not None:
                self._m_mfu.set(mfu)
        return np.concatenate([prompt.astype(np.int32),
                               np.stack(toks, axis=1)], axis=1)

    def engine(self, *, seed: Optional[int] = None, registry=None,
               tracker=None, chunk_tokens: Optional[int] = None,
               tiers=None, device=None):
        """The port's engine over this artifact: a ``DecodeEngine`` (the
        row arena: ``batch`` rows of ``cache_len``, the stamped prompt
        buckets) for v3, a ``PagedDecodeEngine`` for v4 and a
        ``SpecDecodeEngine`` over the stamped draft for v5, with the
        stamped block grid, chunk grid, pool storage and spec depth, and
        the stamped MFU numerator (``cost_analysis.engine_verify`` or
        ``engine_decode`` FLOPs, where the artifact has them). v1 and v2
        carry no engine and raise. ``chunk_tokens`` may only restate a
        paged artifact's grid; on v3 it and ``tiers`` raise (the arena
        has no chunks and no blocks to spill). Runs on the card unless
        ``device="cpu"``."""
        from paddle_tpu_torch.serving.engine import (DecodeEngine,
                                                     PagedDecodeEngine,
                                                     SpecDecodeEngine)
        if not self.engine_buckets:
            raise ValueError(
                f"artifact (format v{self.meta['format_version']}) has no "
                f"engine modules — re-export with save_lm_artifact(..., "
                f"engine_buckets=(...)) for continuous batching")
        device = place.resolve_device(device)
        cost = self.cost_analysis
        paged = self.meta.get("engine_paged")
        if not paged:
            if chunk_tokens is not None:
                raise ValueError(
                    f"chunk_tokens={chunk_tokens}: this artifact (format "
                    f"v{self.meta['format_version']}) has no paged engine, "
                    f"so prefill cannot be chunked — re-export with "
                    f"save_lm_artifact(..., engine_paged=True)")
            if tiers is not None:
                raise ValueError("tiered spill (tiers=) needs a paged-engine "
                                 "artifact — the row arena has no block "
                                 "pool to demote from")
            return DecodeEngine.from_params(
                self._params_on(device), self.cfg, batch=self.meta["batch"],
                cache_len=self.meta["cache_len"],
                buckets=self.engine_buckets, seed=seed, device=device,
                tracker=tracker, registry=registry,
                decode_flops=cost.get("engine_decode", {}).get("flops"))
        stamped = paged.get("pool_layout", "slot_major")
        if stamped != POOL_LAYOUT:
            raise ValueError(f"artifact's engine was exported against a "
                             f"{stamped!r} KV pool; the port's pool is "
                             f"{POOL_LAYOUT!r}")
        chunk = int(paged.get("chunk_tokens", max(self.engine_buckets)))
        if chunk_tokens is not None and int(chunk_tokens) != chunk:
            raise ValueError(f"artifact stamped a chunk grid of {chunk} "
                             f"tokens; chunk_tokens={chunk_tokens} differs")
        kvd = paged.get("kv_dtype", "none")
        kw = dict(batch=self.meta["batch"], cache_len=self.meta["cache_len"],
                  block_size=paged["block_size"],
                  num_blocks=paged["num_blocks"], chunk_tokens=chunk,
                  chunk_buckets=self.engine_buckets, seed=seed,
                  kv_dtype=None if kvd == "none" else kvd, device=device,
                  tracker=tracker, tiers=tiers, registry=registry)
        params = self._params_on(device)
        spec = self.meta.get("engine_spec")
        if not spec:
            return PagedDecodeEngine.from_params(
                params, self.cfg,
                decode_flops=cost.get("engine_decode", {}).get("flops"),
                **kw)
        from paddle_tpu_torch.models import transformer
        dcfg = _cfg_from_dict(spec["draft_config"])
        flops = cost.get("engine_verify", {}).get(
            "flops", cost.get("engine_decode", {}).get("flops"))
        return SpecDecodeEngine.from_params(
            params, self.cfg,
            transformer.params_from_numpy(self.draft_params, dcfg,
                                          device=device),
            dcfg, spec_k=spec["k"], decode_flops=flops, **kw)

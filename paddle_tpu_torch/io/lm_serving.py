"""The LM serving artifact (counterpart of ``paddle_tpu/io/lm_serving.py``):
int8 serving weights, and the format-v4/v5 artifact of the paged engine
and its speculative-decoding variant.

An artifact is one tar: ``meta.json`` (the config, the engine geometry,
the format number), ``params.npz`` (the parameter tree, '/'-joined
paths) and, for format v5, ``draft_params.npz`` (the draft model). The
JAX package also packs compiled XLA modules (``*.bin``); they cannot
run here, so :func:`load_lm_artifact` ignores them and the port builds
its own step programs from the stamped geometry. The port's
:func:`save_lm_artifact` writes weights and meta only, in the same
member layout and format numbers.

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
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.ops import q8

FORMAT_VERSION = 5      # v4: the paged engine; v5: plus a draft model
_ENGINE_FORMATS = (4, 5)
POOL_LAYOUT = "head_major"
_NOT_PORTED = ("is not ported (ROADMAP.md A5: the row-arena engine, the "
               "lockstep prefill/decode and generate)")

# JAX config fields the serving port does not read; each must hold its
# JAX default (the port refuses experts and ring attention itself)
_JAX_ONLY_FIELDS = {"cp_mode": "ring", "use_flash_attention": False,
                    "moe_top_k": 1, "moe_capacity_factor": 1.25,
                    "moe_aux_weight": 0.01}

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
    The result is a serving tree for ``decode_step_paged``,
    ``prefill_into_blocks`` and ``PagedDecodeEngine``, on the card
    unless ``device`` says otherwise.

    Only the fp32 tree is accepted: the serving dict of ``init_params``
    holds the matmul weights already rounded to ``cfg.dtype``, and
    quantizing those gives other bytes than ``paddle_tpu`` does."""
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


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dict/list/tuple trees of arrays -> {'/'-joined path: leaf};
    list and tuple items as ``__<i>`` (the JAX package's checkpoint
    encoding)."""
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


def _leaf_array(t) -> np.ndarray:
    """A tree leaf as the numpy array ``np.savez`` writes: bf16 as raw
    2-byte words (``|V2``), every other dtype as it is."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(t)


def _leaf_tensor(a: np.ndarray):
    """An ``np.load`` leaf: ``|V2`` words as a bf16 tensor with the same
    words; any other array as it is."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.frombuffer(bytearray(a.tobytes()),
                                dtype=torch.bfloat16).reshape(a.shape)
    return a


def _npz_bytes(tree) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **{k: _leaf_array(v) for k, v in _flatten(tree).items()})
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
    """Pack the paged engine's artifact (format v4), or with a draft
    model the spec engine's (v5): the keywords of ``paddle_tpu``'s
    ``save_lm_artifact``, weights and meta only (no compiled modules).
    ``params`` is a tree of tensors or numpy arrays (a serving tree's
    bf16 leaves are stored as raw words, so a load gives them back bit
    for bit); ``weights_int8`` stores the ``quantize_lm_params`` int8
    tree of an fp32 one (an int8 tree is stored as it is). The engine
    buckets are chunk buckets; the chunk grid is their largest. The v1-v3
    formats (the lockstep and row-arena paths) raise ValueError."""
    from paddle_tpu_torch.models import transformer
    if not (engine_paged and engine_buckets):
        raise ValueError(f"save_lm_artifact: only the paged engine's "
                         f"formats (engine_paged=True with engine_buckets) "
                         f"are written; the lockstep and row-arena formats "
                         f"{_NOT_PORTED}")
    if cache_len > cfg.max_len:
        raise ValueError(f"cache_len {cache_len} exceeds cfg.max_len "
                         f"{cfg.max_len}")
    if (engine_draft_params is None) != (engine_draft_config is None):
        raise ValueError("engine_draft_params and engine_draft_config come "
                         "together (the draft model for speculative "
                         "decoding)")
    if engine_draft_config is not None \
            and engine_draft_config.vocab != cfg.vocab:
        raise ValueError(f"draft vocab {engine_draft_config.vocab} != "
                         f"target vocab {cfg.vocab}")
    buckets = sorted({int(b) for b in engine_buckets})
    if buckets[0] < 1 or buckets[-1] > cache_len:
        raise ValueError(f"engine_buckets {buckets} outside "
                         f"[1, cache_len={cache_len}]")
    bs = int(engine_block_size)
    chunk = buckets[-1]
    if bs < 1 or chunk % bs or cache_len % chunk:
        raise ValueError(f"paged export needs block_size {bs} | chunk "
                         f"{chunk} | cache_len {cache_len}")
    if weights_int8 and not transformer._blocks_quantized(params):
        params = quantize_lm_params(params, device="cpu")
    weights_int8 = weights_int8 or transformer._blocks_quantized(params)
    pages = cache_len // bs
    meta = {"format_version": 5 if engine_draft_params is not None else 4,
            "batch": int(batch), "prompt_len": int(prompt_len),
            "cache_len": int(cache_len), "weights_int8": bool(weights_int8),
            "config": _cfg_to_dict(cfg), "cost_analysis": {},
            "engine_buckets": buckets,
            "engine_paged": {
                "block_size": bs,
                "num_blocks": int(engine_num_blocks
                                  if engine_num_blocks is not None
                                  else batch * pages),
                "pages_per_slot": pages, "chunk_tokens": chunk,
                "kv_dtype": engine_kv_dtype or "none",
                "pool_layout": POOL_LAYOUT}}
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
    """Read a format-v4 or v5 artifact (``paddle_tpu``'s or the port's):
    meta, weights and, for v5, the draft. Compiled modules are ignored.
    Older formats raise ValueError."""
    with tarfile.open(path, "r") as tar:
        members = {m.name: tar.extractfile(m).read()
                   for m in tar.getmembers()
                   if not m.name.endswith(".bin")}
    meta = json.loads(members["meta.json"])
    version = meta["format_version"]
    if version > FORMAT_VERSION:
        raise ValueError(f"artifact format {version} newer than this "
                         f"loader ({FORMAT_VERSION})")
    if version not in _ENGINE_FORMATS:
        raise ValueError(f"artifact format v{version}: only the paged "
                         f"engine's formats {_ENGINE_FORMATS} load; the "
                         f"lockstep and row-arena paths {_NOT_PORTED}")
    draft = members.get("draft_params.npz")
    return LMServer(meta, _npz_tree(members["params.npz"]),
                    _npz_tree(draft) if draft is not None else None)


class LMServer:
    """A loaded artifact: its ``meta``, the weights (``params``, numpy
    arrays and, for bf16 leaves, bf16 tensors) and, for v5, the draft's
    (``draft_params``). :meth:`engine` builds the port's engine from the
    stamped geometry; ``generate()`` (the lockstep path) is not ported.
    Each server carries its own metrics registry."""

    def __init__(self, meta: dict, params, draft_params=None):
        self.meta = meta
        self.cfg = _cfg_from_dict(meta["config"])
        self.params = params
        self.draft_params = draft_params
        self.engine_buckets = tuple(meta.get("engine_buckets", ()))
        self.cost_analysis = meta.get("cost_analysis", {})
        reg = self.metrics = _metrics.Registry()
        self._m_requests = reg.counter(
            "lm_generate_requests_total", "generate() calls")
        self._m_tokens = reg.counter(
            "lm_tokens_generated_total", "tokens sampled across all calls")
        self._m_decode = reg.counter(
            "lm_decode_calls_total", "incremental decode steps served")

    def metrics_text(self) -> str:
        """Prometheus text exposition snapshot of this server's metrics."""
        return self.metrics.render_prometheus()

    def health(self) -> dict:
        """/healthz document: request/token progress of this server."""
        return {"requests": int(self._m_requests.value()),
                "tokens_generated": int(self._m_tokens.value()),
                "decode_steps": int(self._m_decode.value()),
                "seconds_since_request": None,
                "batch": self.meta["batch"],
                "cache_len": self.meta["cache_len"]}

    def generate(self, *args, **kwargs):
        raise ValueError(f"LMServer.generate {_NOT_PORTED}; serve through "
                         f"engine()")

    def engine(self, *, seed: Optional[int] = None, registry=None,
               tracker=None, chunk_tokens: Optional[int] = None,
               tiers=None, device=None):
        """The port's engine over this artifact: a ``PagedDecodeEngine``
        for v4, a ``SpecDecodeEngine`` over the stamped draft for v5,
        with the stamped batch, cache length, block grid, chunk grid and
        buckets, pool storage and spec depth, and the stamped MFU
        numerator (``cost_analysis.engine_verify`` or ``engine_decode``
        FLOPs, where the artifact has them). ``chunk_tokens`` may only
        restate the stamped grid. Runs on the card unless
        ``device="cpu"``."""
        from paddle_tpu_torch.models import transformer
        from paddle_tpu_torch.serving.engine import (PagedDecodeEngine,
                                                     SpecDecodeEngine)
        paged = self.meta["engine_paged"]
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
        device = place.resolve_device(device)
        kw = dict(batch=self.meta["batch"], cache_len=self.meta["cache_len"],
                  block_size=paged["block_size"],
                  num_blocks=paged["num_blocks"], chunk_tokens=chunk,
                  chunk_buckets=self.engine_buckets, seed=seed,
                  kv_dtype=None if kvd == "none" else kvd, device=device,
                  tracker=tracker, tiers=tiers, registry=registry)
        params = transformer.params_from_numpy(self.params, self.cfg,
                                               device=device)
        cost = self.cost_analysis
        spec = self.meta.get("engine_spec")
        if not spec:
            return PagedDecodeEngine.from_params(
                params, self.cfg,
                decode_flops=cost.get("engine_decode", {}).get("flops"),
                **kw)
        dcfg = _cfg_from_dict(spec["draft_config"])
        flops = cost.get("engine_verify", {}).get(
            "flops", cost.get("engine_decode", {}).get("flops"))
        return SpecDecodeEngine.from_params(
            params, self.cfg,
            transformer.params_from_numpy(self.draft_params, dcfg,
                                          device=device),
            dcfg, spec_k=spec["k"], decode_flops=flops, **kw)

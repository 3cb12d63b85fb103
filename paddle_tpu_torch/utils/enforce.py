"""Error enforcement (counterpart of ``paddle_tpu/utils/enforce.py``;
reference: paddle/platform/enforce.h — PADDLE_ENFORCE / PADDLE_THROW,
paddle/utils/CustomStackTrace.h layer-stack error context).

``layer_scope`` pushes the running layer's name, so an error inside a
layer's forward reports which layer of the user's topology failed.
"""

import contextlib
import threading

import numpy as np


class EnforceError(RuntimeError):
    pass


_ctx = threading.local()


def _stack():
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


@contextlib.contextmanager
def layer_scope(name: str):
    """Push a layer name onto the error-context stack while running it."""
    _stack().append(name)
    try:
        yield
    except Exception as e:
        # annotate once, at the innermost frame
        if not getattr(e, "_paddle_tpu_annotated", False):
            e._paddle_tpu_annotated = True
            trace = " -> ".join(_stack())
            e.args = (f"{e.args[0] if e.args else e}\n  [layer stack: {trace}]",) + \
                tuple(e.args[1:])
        raise
    finally:
        _stack().pop()


def enforce(cond, msg="", *fmt_args):
    """PADDLE_ENFORCE equivalent."""
    if not cond:
        raise EnforceError(msg % fmt_args if fmt_args else msg)


def enforce_eq(a, b, msg=""):
    if a != b:
        raise EnforceError(f"enforce_eq failed: {a!r} != {b!r}. {msg}")


def enforce_shape_match(shape_a, shape_b, msg=""):
    if tuple(shape_a) != tuple(shape_b):
        raise EnforceError(f"shape mismatch: {tuple(shape_a)} vs {tuple(shape_b)}. {msg}")


def _leaves_with_path(tree, path=""):
    """(path, leaf) over dicts, lists, tuples and dataclass-like objects
    with ``__dict__`` fields (a ``Value``), in the key-path notation of
    ``jax.tree_util.keystr`` (``['a'][0]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is None:
        return
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _leaves_with_path(getattr(tree, k), f"{path}.{k}")
    else:
        yield path, tree


def check_numerics(tree, name="value"):
    """Raise EnforceError if any floating leaf of ``tree`` (tensors or
    arrays in dicts, lists, tuples and Values) holds NaN/Inf — the
    host-side finite tripwire (reference: the FE_* traps of
    TrainerMain.cpp:49)."""
    import torch
    bad = []
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            arr = leaf.detach().float().cpu().numpy()
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
        if not np.isfinite(arr).all():
            n_nan = int(np.isnan(arr).sum())
            n_inf = int(np.isinf(arr).sum())
            bad.append(f"{name}{path}: "
                       f"{n_nan} NaN, {n_inf} Inf of {arr.size}")
    if bad:
        raise EnforceError("non-finite values detected:\n  " +
                           "\n  ".join(bad))

"""Device synchronisation for timing loops (counterpart of
``paddle_tpu/utils/sync.py``).

CUDA launches return before the work is done, so a wall-clock reading
taken after a loop of steps needs a barrier on the device the tensors
live on. ``host_sync`` is that barrier: it synchronises the device of
the tree's first tensor, then reads a value back, as the JAX helper
does, so call sites get the number they forced."""

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return []


def host_sync(tree, *scalars) -> float:
    """Block until the work on ``tree``'s device (and any extra device
    scalars) is done. Returns the float of the last scalar, or the sum of
    the first leaf when none is given (0.0 for an empty tree)."""
    leaves = _leaves(tree)
    devices = {t.device for t in leaves[:1] + [s for s in scalars
                                               if isinstance(s, torch.Tensor)]}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    out = 0.0
    if leaves:
        out = float(leaves[0].detach().float().sum())
    for s in scalars:
        out = float(s)
    return out

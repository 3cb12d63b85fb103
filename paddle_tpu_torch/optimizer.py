"""Optimizers as update rules over parameter trees (counterpart of
``paddle_tpu/optimizer.py``).

The learning-rate schedules, L1/L2 regularization folded into the
gradient, global-norm clipping and the per-array rules (SGD, Momentum,
AdaGrad, AdaDelta, RMSProp, Adam, AdamW, AdaMax, DecayedAdagrad,
ProximalGD, ProximalAdagrad) compute what the JAX package computes, in
fp32, with fp32 state. ``init_state`` / ``update`` work on flat
``{name: tensor}`` dicts; ``tree_init_state`` / ``tree_update`` on a
nested dict such as the transformer's, whose leaves are named by their
JAX keystr path (``"['blocks']['qkv']"``) so state moves between the
two packages leaf for leaf (:func:`state_to_numpy`,
:func:`state_from_numpy`) and an AdamW ``decay_mask`` callable sees the
same names.

Unlike the JAX version, ``update`` and ``tree_update`` write the new
values INTO the parameter leaves (under ``torch.no_grad()``), one leaf
at a time, so no second copy of the weights is held and tensors that
require grad stay the leaves autograd fills; the state comes back as
new tensors, as in JAX.

``bind(specs)`` attaches the layer API's per-parameter attributes
(``core/param.ParamAttr``): ``is_static`` leaves are skipped (their
state kept), ``learning_rate`` scales the step, ``l1_rate`` /
``l2_rate`` replace the global regularization for that leaf.
``ModelAverage`` keeps a bounded-window average beside training;
``StaticPruning`` masks the gradients of the hooked leaves and prunes
them in place after every update.
"""

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.param import ParamSpec


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------

def constant_schedule(base_lr):
    return lambda step: _f32(base_lr)


def poly_schedule(base_lr, a, b):
    """lr = base * (1 + a*step)^(-b)"""
    return lambda step: base_lr * torch.pow(1.0 + a * _f32(step), -b)


def exp_schedule(base_lr, a, b):
    """lr = base * a^(step/b)"""
    return lambda step: base_lr * torch.pow(_f32(a), _f32(step) / b)


def discexp_schedule(base_lr, a, b):
    """lr = base * a^floor(step/b)"""
    return lambda step: base_lr * torch.pow(_f32(a),
                                            torch.floor(_f32(step) / b))


def linear_schedule(base_lr, a, b):
    """lr = max(base - a*step, b)"""
    return lambda step: torch.clamp_min(base_lr - a * _f32(step), b)


def warmup_cosine_schedule(base_lr, warmup_steps, total_steps, min_lr=0.0):
    """Linear warm-up to ``base_lr``, then a cosine to ``min_lr``."""
    def fn(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi
                                                                 * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def make_schedule(learning_rate, learning_rate_schedule=None,
                  learning_rate_args=""):
    """The reference's string-typed schedule config (name plus
    comma-separated args), or a callable ``step -> lr``."""
    if callable(learning_rate_schedule):
        return learning_rate_schedule
    name = learning_rate_schedule or "constant"
    args = [float(x) for x in str(learning_rate_args).split(",") if x != ""]
    makers = {"constant": constant_schedule, "poly": poly_schedule,
              "exp": exp_schedule, "discexp": discexp_schedule,
              "linear": linear_schedule}
    if name not in makers:
        raise ValueError(f"unknown lr schedule {name!r}")
    return makers[name](learning_rate, *args)


# ---------------------------------------------------------------------------
# regularization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class L2Regularization:
    rate: float


@dataclasses.dataclass
class L1Regularization:
    rate: float


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(keystr path, leaf) of a nested dict, keys sorted at every level
    as ``jax.tree_util`` orders them."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [leaf for k in sorted(tree)
            for leaf in tree_leaves(tree[k], f"{prefix}['{k}']")]


def take_grads(params):
    """The ``.grad`` of every leaf of ``params`` as a tree of the same
    structure (zeros where a leaf got none); each leaf's ``.grad`` is
    reset to None, so the next backward starts from nothing."""
    if isinstance(params, dict):
        return {k: take_grads(v) for k, v in params.items()}
    g = params.grad if params.grad is not None else torch.zeros_like(params)
    params.grad = None
    return g


def _state_map(fn, state: Dict) -> Dict:
    """Apply ``fn`` to every array of an optimizer state (each leaf's
    state is (), one array, or a tuple of arrays)."""
    def one(s):
        return tuple(fn(a) for a in s) if isinstance(s, tuple) else fn(s)
    return {k: one(s) for k, s in state.items()}


def state_to_numpy(state: Dict) -> Dict:
    """Optimizer state as fp32 numpy, the layout ``paddle_tpu`` uses."""
    return _state_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                      state)


def state_from_numpy(state: Dict, device) -> Dict:
    """``paddle_tpu`` optimizer state, as numpy, on ``device``."""
    device = torch.device(device)
    return _state_map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32).copy()).to(device), state)


# ---------------------------------------------------------------------------
# optimizer base
# ---------------------------------------------------------------------------

class Optimizer:
    """A per-array update rule with schedules, regularization and
    clipping around it.

    init_state(params) -> state; update(step, grads, params, state) ->
    (params, new_state), both on flat ``{name: tensor}`` dicts, the new
    values written into ``params`` in place."""

    def __init__(self, learning_rate=0.01, regularization=None,
                 gradient_clipping_threshold=None,
                 learning_rate_schedule=None, learning_rate_args=""):
        self.schedule = make_schedule(learning_rate, learning_rate_schedule,
                                      learning_rate_args)
        self.regularization = regularization
        self.clip_threshold = gradient_clipping_threshold
        self.specs: Dict[str, ParamSpec] = {}

    def bind(self, specs):
        """Attach per-parameter attrs (lr scale, per-param decay, static)."""
        self.specs = {s.name: s for s in specs}
        return self

    # -- per-array rules, overridden by subclasses -------------------------
    def _init_one(self, p):
        return ()

    def _update_one(self, g, p, s, lr):
        raise NotImplementedError

    # -- flat dicts --------------------------------------------------------
    @torch.no_grad()
    def init_state(self, params: Dict) -> Dict:
        return {k: self._init_one(v.detach()) for k, v in params.items()}

    def _decay(self, name, g, p):
        """Regularization as gradient decay: g + l2*p + l1*sign(p), the
        leaf's bound ``l1_rate`` / ``l2_rate`` over the global rate."""
        spec = self.specs.get(name)
        l1 = getattr(spec.attr, "l1_rate", None) if spec else None
        l2 = getattr(spec.attr, "l2_rate", None) if spec else None
        if l2 is None and isinstance(self.regularization, L2Regularization):
            l2 = self.regularization.rate
        if l1 is None and isinstance(self.regularization, L1Regularization):
            l1 = self.regularization.rate
        gf = g.float()
        if l2:
            gf = gf + l2 * p.float()
        if l1:
            gf = gf + l1 * torch.sign(p.float())
        return gf

    def _clip(self, grads: Dict) -> Dict:
        """Global-norm clipping to ``gradient_clipping_threshold``."""
        if not self.clip_threshold:
            return grads
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        scale = torch.clamp_max(self.clip_threshold / (gnorm + 1e-12), 1.0)
        return {k: g * scale.to(g.dtype) for k, g in grads.items()}

    def _after(self, name, new, p, lr):
        """Hook on each leaf's new fp32 value before it is written, with
        the leaf's old value ``p`` (AdamW's decoupled decay)."""
        return new

    @torch.no_grad()
    def update(self, step, grads: Dict, params: Dict, state: Dict):
        """One step on flat dicts. Each leaf's new value is written into
        it as soon as it is computed, so no second copy of the
        parameters is held; a static leaf (bound ``is_static``) is left
        as it is, with its state. Returns (params, new_state)."""
        lr_t = self.schedule(step)
        grads = self._clip(grads)
        new_s = {}
        for name, p in params.items():
            spec = self.specs.get(name)
            if spec is not None and spec.attr.is_static:
                new_s[name] = state[name]
                continue
            lr = lr_t * (spec.attr.learning_rate if spec else 1.0)
            pf = p.float()
            new, new_s[name] = self._update_one(
                self._decay(name, grads[name], p), pf, state[name], lr)
            p.copy_(self._after(name, new, pf, lr))
        return params, new_s

    # -- nested trees (the transformer's parameter dict) --------------------
    def tree_init_state(self, params) -> Dict:
        """init_state for a nested parameter dict, keyed by keystr path.
        Per-parameter attrs bound via ``bind()`` apply only when spec
        names use that same path format; ``tree_update`` warns if bound
        specs match no leaf."""
        return self.init_state(dict(tree_leaves(params)))

    def tree_update(self, step, grads, params, state):
        """update() for a nested parameter dict and its gradient tree
        (as :func:`take_grads` returns it), the leaves named by keystr
        path; returns (params, new_state)."""
        pd = dict(tree_leaves(params))
        unmatched = set(self.specs) - set(pd)
        if unmatched and not getattr(self, "_warned_spec_mismatch", False):
            self._warned_spec_mismatch = True
            from paddle_tpu_torch.utils.logger import get_logger
            get_logger().warning(
                "optimizer: bound parameter specs %s match no pytree leaf "
                "path (leaves look like %s) — their per-parameter rules "
                "are NOT being applied", sorted(unmatched)[:5],
                list(pd)[:3])
        _, new_s = self.update(step, dict(tree_leaves(grads)), pd, state)
        return params, new_s


class SGD(Optimizer):
    """Plain SGD."""

    def _update_one(self, g, p, s, lr):
        return p - lr * g, s


class Momentum(Optimizer):
    """Heavy-ball momentum; ``use_nesterov`` for NAG."""

    def __init__(self, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(**kw)
        self.mu = momentum
        self.nesterov = use_nesterov

    def _init_one(self, p):
        return torch.zeros_like(p, dtype=torch.float32)

    def _update_one(self, g, p, v, lr):
        nv = self.mu * v + g
        if self.nesterov:
            return p - lr * (g + self.mu * nv), nv
        return p - lr * nv, nv


class AdaGrad(Optimizer):
    def __init__(self, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.eps = epsilon

    def _init_one(self, p):
        return torch.zeros_like(p, dtype=torch.float32)

    def _update_one(self, g, p, acc, lr):
        nacc = acc + g * g
        return p - lr * g / (torch.sqrt(nacc) + self.eps), nacc


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def _init_one(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update_one(self, g, p, s, lr):
        acc_g, acc_dx = s
        acc_g = self.rho * acc_g + (1 - self.rho) * g * g
        dx = torch.sqrt((acc_dx + self.eps) / (acc_g + self.eps)) * g
        acc_dx = self.rho * acc_dx + (1 - self.rho) * dx * dx
        return p - lr * dx, (acc_g, acc_dx)


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, momentum=0.0, **kw):
        super().__init__(**kw)
        self.rho, self.eps, self.mu = rho, epsilon, momentum

    def _init_one(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update_one(self, g, p, s, lr):
        acc, mom = s
        acc = self.rho * acc + (1 - self.rho) * g * g
        step = lr * g / torch.sqrt(acc + self.eps)
        mom = self.mu * mom + step
        return p - mom, (acc, mom)


class Adam(Optimizer):
    """Adam with bias correction; state (m, v) per leaf."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def _init_one(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def update(self, step, grads, params, state):
        self._t = _f32(step) + 1.0
        return super().update(step, grads, params, state)

    def _update_one(self, g, p, s, lr):
        m, v = s
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * g * g
        mhat = m / (1 - torch.pow(_f32(self.b1), self._t))
        vhat = v / (1 - torch.pow(_f32(self.b2), self._t))
        return p - lr * mhat / (torch.sqrt(vhat) + self.eps), (m, v)


class AdamW(Adam):
    """Adam with decoupled weight decay, applied to the parameter after
    the Adam step. ``decay_mask``: ``"all"`` (every leaf), ``"no_1d"``
    (leaves of ndim > 1 only) or a callable ``(name, param) -> bool``
    (True decays; ``name`` is the keystr path under ``tree_update``)."""

    def __init__(self, weight_decay=0.01, decay_mask="all", **kw):
        if kw.get("regularization") is not None:
            raise ValueError(
                "AdamW applies decoupled weight_decay; combining it with "
                "regularization= would decay parameters twice. Use plain "
                "Adam for gradient-coupled L1/L2.")
        super().__init__(**kw)
        self.weight_decay = weight_decay
        if not (decay_mask in ("all", "no_1d") or callable(decay_mask)):
            raise ValueError(f"decay_mask must be 'all', 'no_1d' or a "
                             f"callable, got {decay_mask!r}")
        self.decay_mask: Callable = decay_mask

    def _decays(self, name, p):
        if self.decay_mask == "all":
            return True
        if self.decay_mask == "no_1d":
            return p.ndim > 1
        return bool(self.decay_mask(name, p))

    def _after(self, name, new, p, lr):
        if self._decays(name, p):
            return new - lr * self.weight_decay * p
        return new


class AdaMax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def _init_one(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def update(self, step, grads, params, state):
        self._t = _f32(step) + 1.0
        return super().update(step, grads, params, state)

    def _update_one(self, g, p, s, lr):
        m, u = s
        m = self.b1 * m + (1 - self.b1) * g
        u = torch.maximum(self.b2 * u, torch.abs(g))
        return (p - lr / (1 - torch.pow(_f32(self.b1), self._t)) * m
                / (u + 1e-12), (m, u))


class DecayedAdagrad(Optimizer):
    """Adagrad with a decayed accumulator."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def _init_one(self, p):
        return torch.zeros_like(p, dtype=torch.float32)

    def _update_one(self, g, p, acc, lr):
        nacc = self.rho * acc + (1 - self.rho) * g * g
        return p - lr * g / (torch.sqrt(nacc) + self.eps), nacc


def _prox(w, shrink, l1, l2):
    """sign(w) * max(|w| - shrink*l1, 0) / (1 + shrink*l2)."""
    if l1:
        w = torch.sign(w) * torch.clamp_min(torch.abs(w) - shrink * l1, 0.0)
    if l2:
        w = w / (1.0 + shrink * l2)
    return w


class ProximalGD(Optimizer):
    """The plain step, then the L1/L2 proximal projection."""

    def __init__(self, l1=0.0, l2=0.0, **kw):
        super().__init__(**kw)
        self.l1, self.l2 = l1, l2

    def _update_one(self, g, p, s, lr):
        return _prox(p - lr * g, lr, self.l1, self.l2), s


class ProximalAdagrad(Optimizer):
    """The Adagrad step, then the same projection at the adaptive
    rate."""

    def __init__(self, l1=0.0, l2=0.0, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.l1, self.l2, self.eps = l1, l2, epsilon

    def _init_one(self, p):
        return torch.zeros_like(p, dtype=torch.float32)

    def _update_one(self, g, p, acc, lr):
        nacc = acc + g * g
        alr = lr / (torch.sqrt(nacc) + self.eps)
        return _prox(p - alr * g, alr, self.l1, self.l2), nacc


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class ModelAverage:
    """Bounded-window parameter averaging (reference: AverageOptimizer,
    parameter/AverageOptimizer.cpp — window = min(steps * average_window,
    max_average_window)). A running mean that turns into an EMA with
    decay 1-1/window once the window fills. Functional, over a (nested)
    dict of tensors: accumulate beside training, swap in averaged() for
    eval."""

    def __init__(self, average_window=0.0, max_average_window=10000):
        self.window = float(max_average_window or 10000)

    @torch.no_grad()
    def init_state(self, params):
        avg = _tree_map(lambda p: p.detach().float().clone(), params)
        dev = tree_leaves(params)[0][1].device if params else "cpu"
        return {"avg": avg,
                "count": torch.zeros((), dtype=torch.float32, device=dev)}

    @torch.no_grad()
    def accumulate(self, params, state):
        c = state["count"] + 1.0
        decay = torch.clamp_max((c - 1.0) / c, 1.0 - 1.0 / self.window)
        return {"avg": _tree_map(
            lambda a, p: decay * a + (1.0 - decay) * p.detach().float(),
            state["avg"], params), "count": c}

    def averaged(self, params, state):
        return _tree_map(lambda a, p: a.to(p.dtype), state["avg"], params)


class StaticPruning:
    """Magnitude pruning mask applied to a trained/initial parameter set and
    every subsequent update (reference: StaticPruningHook,
    parameter/ParameterUpdaterHook.cpp:39 — zeroes the smallest
    ``sparsity_ratio`` fraction of each hooked parameter by |w| and keeps
    them zero through training).

    Usage: masks = StaticPruning(ratio).make_masks(params, names); wrap
    the optimizer with .apply(optimizer): each update masks the hooked
    gradients, writes the new values into the leaves, then prunes the
    leaves in place."""

    def __init__(self, sparsity_ratio: float):
        assert 0.0 <= sparsity_ratio < 1.0
        self.ratio = sparsity_ratio
        self.masks = {}

    def make_masks(self, params, names=None):
        """Build {name: 0/1 float32 mask} on each leaf's device from its
        current magnitudes (the hook ran at init / after load). Exactly
        the k smallest-|w| entries are pruned (rank-based, so magnitude
        ties — e.g. zero-initialised tensors — never over-prune)."""
        self.masks.clear()
        for name, p in params.items():
            if names is not None and name not in names:
                continue
            mag = np.abs(p.detach().to("cpu", torch.float32).numpy()
                         ).reshape(-1)
            k = int(self.ratio * mag.size)
            mask = np.ones(mag.size, np.float32)
            if k > 0:
                mask[np.argpartition(mag, k - 1)[:k]] = 0.0
            self.masks[name] = torch.from_numpy(
                mask.reshape(tuple(p.shape))).to(p.device)
        return self.masks

    @torch.no_grad()
    def prune(self, params):
        """Zero the pruned entries of the hooked leaves, in place;
        returns ``params``."""
        for k, m in self.masks.items():
            if k in params:
                params[k].mul_(m.to(params[k].dtype))
        return params

    def apply(self, optimizer: Optimizer) -> Optimizer:
        """Wrap optimizer.update so every step masks the gradients and
        re-prunes the updated leaves.

        Call make_masks() FIRST: a wrapper without masks would silently
        train unpruned — apply() refuses it. Re-wrapping the same
        optimizer also raises (double-masking)."""
        if not self.masks:
            raise ValueError(
                "StaticPruning.apply() before make_masks(): build the "
                "masks first")
        if getattr(optimizer, "_pruning_wrapped", False):
            raise ValueError("optimizer already wrapped by StaticPruning")
        inner = optimizer.update
        hook = self

        def update(step, grads, params, state):
            masks = hook.masks
            grads = {k: (g * masks[k].to(g.dtype) if k in masks else g)
                     for k, g in grads.items()}
            params, new_s = inner(step, grads, params, state)
            return hook.prune(params), new_s

        optimizer.update = update
        optimizer._pruning_wrapped = True
        return optimizer

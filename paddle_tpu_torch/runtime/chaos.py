"""Fault injection for chaos tests — the ``PADDLE_TPU_CHAOS`` knob
(counterpart of ``paddle_tpu/runtime/chaos.py``, the same grammar).

The elastic chaos tests need to kill, hang, or crash a worker at a
PRECISE point (a named training step, a checkpoint-commit phase)
without threading ad-hoc ``os.kill`` plumbing through every layer.
Instead the instrumented sites — the trainer's batch loop, the
checkpoint writer's commit phases — call ``maybe_trigger(site, ...)``
with their current coordinates, and the env knob decides what fires:

    PADDLE_TPU_CHAOS="kill@step:step=5:rank=1"
    PADDLE_TPU_CHAOS="hang@step:step=3:seconds=30"
    PADDLE_TPU_CHAOS="crash@checkpoint:phase=pre_manifest"
    PADDLE_TPU_CHAOS="exit@step:step=2:rank=0:code=3,kill@step:step=9"

Grammar: comma-separated rules, each ``ACTION@SITE[:key=value...]``.
A rule fires when its site matches and EVERY key it names equals the
call's attribute (ints compare numerically; missing call attrs are
filled from the env — ``rank`` from PADDLE_PROCESS_ID, ``epoch`` from
PADDLE_ELASTIC_EPOCH — so ``epoch=1`` scopes a fault to the first gang
incarnation and a restarted worker sails past it). Each rule fires at
most ``count`` times per process (default 1; ``count=0`` = always).

Actions:
    kill   — SIGKILL this process (no cleanup, the preemption model)
    exit   — ``os._exit(code)`` (default 1): sudden but with exit code
    hang   — sleep ``seconds`` (default 3600): the wedged-worker model
    crash  — raise ``ChaosError``: an in-thread software failure

Sites instrumented in the port: ``step`` (trainer batch loop, attrs
``step``/``rank``/``epoch``) and ``checkpoint`` (``io/checkpoint.py``'s
commit, attrs ``phase``/``step``; phases ``pre_write``, ``pre_manifest``,
``pre_commit`` and ``mid_commit``), as in the JAX package. Anything can
add a site — it is just a ``maybe_trigger`` call.

Stdlib-only; ``maybe_trigger`` is a no-op dict lookup when the env var
is unset, so instrumented hot paths pay nothing in production.
"""

import os
import signal
import threading
import time
from typing import Dict, List, Optional

from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("chaos")

ENV_VAR = "PADDLE_TPU_CHAOS"


class ChaosError(RuntimeError):
    """The injected software failure (action ``crash``)."""


class _Rule:
    __slots__ = ("action", "site", "attrs", "count", "fired")

    def __init__(self, action: str, site: str, attrs: Dict[str, str],
                 count: int):
        self.action = action
        self.site = site
        self.attrs = attrs
        self.count = count          # 0 = unlimited
        self.fired = 0

    def __repr__(self):
        kv = ":".join(f"{k}={v}" for k, v in self.attrs.items())
        return f"{self.action}@{self.site}" + (f":{kv}" if kv else "")


def _parse(spec: str) -> List[_Rule]:
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        head, *kvs = part.split(":")
        if "@" not in head:
            log.warning("chaos: malformed rule %r (need ACTION@SITE)", part)
            continue
        action, site = head.split("@", 1)
        if action not in ("kill", "exit", "hang", "crash"):
            log.warning("chaos: unknown action %r in %r", action, part)
            continue
        attrs, count = {}, 1
        ok = True
        for kv in kvs:
            if "=" not in kv:
                log.warning("chaos: malformed attr %r in %r", kv, part)
                ok = False
                break
            k, v = kv.split("=", 1)
            if k == "count":
                try:
                    count = int(v)
                except ValueError:
                    log.warning("chaos: malformed count %r in %r", v, part)
                    ok = False
                    break
            else:
                attrs[k] = v
        if ok:
            rules.append(_Rule(action, site, attrs, count))
    return rules


_lock = threading.Lock()
_cache_spec: Optional[str] = None
_cache_rules: List[_Rule] = []


def _rules_for(spec: str) -> List[_Rule]:
    """Parse-once cache keyed on the env value; fire counts live on the
    cached rule objects so ``count`` is per-process, not per-call."""
    global _cache_spec, _cache_rules
    with _lock:
        if spec != _cache_spec:
            _cache_spec = spec
            _cache_rules = _parse(spec)
        return _cache_rules


def reset():
    """Drop the parse cache and fire counts (tests)."""
    global _cache_spec, _cache_rules
    with _lock:
        _cache_spec = None
        _cache_rules = []


def _env_default(key: str) -> Optional[str]:
    if key == "rank":
        return os.environ.get("PADDLE_PROCESS_ID")
    if key == "epoch":
        return os.environ.get("PADDLE_ELASTIC_EPOCH")
    return None


#: per-action parameter keys — consumed by the ACTION, not matched
#: against the call site (exit@step:step=2:code=3 must fire at step 2,
#: not wait for a call that passes code=)
_ACTION_PARAMS = {"exit": {"code"}, "hang": {"seconds"}}


def _matches(rule: _Rule, attrs: Dict) -> bool:
    params = _ACTION_PARAMS.get(rule.action, ())
    for k, want in rule.attrs.items():
        if k in params:
            continue
        have = attrs.get(k)
        if have is None:
            have = _env_default(k)
        if have is None:
            return False
        try:
            if int(want) == int(have):
                continue
            return False
        except (TypeError, ValueError):
            pass
        if str(want) != str(have):
            return False
    return True


def maybe_trigger(site: str, **attrs):
    """Fire any armed rule matching (site, attrs). Call this from the
    point being chaos-tested; with PADDLE_TPU_CHAOS unset it is a
    single dict lookup."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    for rule in _rules_for(spec):
        if rule.site != site:
            continue
        if rule.count and rule.fired >= rule.count:
            continue
        if not _matches(rule, attrs):
            continue
        rule.fired += 1
        _fire(rule, site, attrs)


def _fire(rule: _Rule, site: str, attrs: Dict):
    log.warning("chaos: firing %r at %s %s (pid %d)", rule, site,
                attrs, os.getpid())
    if rule.action == "kill":
        # SIGKILL self: the preemption model — no atexit, no flushes
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)              # the signal needs a schedule tick
    elif rule.action == "exit":
        os._exit(int(rule.attrs.get("code", 1)))
    elif rule.action == "hang":
        time.sleep(float(rule.attrs.get("seconds", 3600)))
    elif rule.action == "crash":
        raise ChaosError(f"injected crash: {rule!r} at {site} {attrs}")

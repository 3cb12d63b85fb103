"""Fleet control plane: self-healing, wedge-kills, and SLO-driven
elastic capacity over a serving fleet (counterpart of
``paddle_tpu/serving/autoscale.py``: the same decisions, flight-recorder
records and ``fleet_*`` metrics).

The :class:`FleetController` is the first component that COMMANDS the
fleet rather than observing it. It closes three loops no component
closes alone, with no human in any of them:

**Self-healing.** A replica the router marks ``dead`` (SIGKILL, OOM,
wedge hammer below) is respawned under its OWN name by the fleet
backend — so a ``{name}``-templated spill directory carries over and
the replacement's disk tier re-adopts the dead incarnation's published
prefixes on startup — then re-registered with the router
(:meth:`~paddle_tpu_torch.serving.router.Router.replace_replica`) and
re-warmed: the prefixes the router recently placed there are
re-imported over the KV transfer wire from warm survivors
(:meth:`~paddle_tpu_torch.serving.router.Router.rewarm_replica`). Restart
policy is the training supervisor's, verbatim — the extracted
:class:`~paddle_tpu_torch.runtime.supervisor.RestartBudget` gives each
replica a consecutive-unstable budget with decorrelated-jitter backoff
and stable-incarnation refill; an exhausted budget retires the name
(``fleet_heal_abandoned_total``) instead of crash-looping.

**Wedge detection.** A replica that is transport-alive but has made no
progress on a non-empty outstanding set for ``wedge_timeout_s`` is
SIGKILLed (``fleet_wedge_kills_total``) — the dead transport then
routes through the ordinary requeue + healing path. Liveness is the
transport's verdict; PROGRESS is the controller's.

**Elastic capacity.** Queue depth and the router's TTFT SLO burn rate,
sustained past a hysteresis window, spawn replicas up to
``max_replicas`` — bounded by a spawn token budget
(``spawn_budget`` per ``spawn_budget_window_s``) so flapping load
cannot thrash the fleet. A sustained idle fleet drains its newest
surplus replica through the graceful SIGTERM path (admissions stop,
in-flight finishes, then the process exits 0) down to
``min_replicas``.

Every decision lands in the flight recorder ring (dumped with any
post-mortem) and as ``fleet_*`` metrics in the ROUTER registry, so the
one ``/metrics`` + ``/healthz`` scrape that answers for the fleet
answers for its control plane too.

The controller is single-threaded and steppable like everything else
in the serving stack: drive :meth:`step` alongside ``router.step()``
(the ``route`` CLI loop does both). The fleet backend is anything with
the :class:`ServingFleet` named-lifecycle surface — ``spawn(name)`` /
``handle(name)`` / ``stop(name)`` / ``kill_name(name)`` —
:class:`InProcessFleet` provides it over in-process engines for tests
and the smoke run's in-process gate, where every replica shares one
card and one host thread.
"""

import logging
import time
from collections import deque
from typing import Dict, Optional

from paddle_tpu_torch.observe import flight as _flight
from paddle_tpu_torch.runtime.supervisor import RestartBudget

logger = logging.getLogger(__name__)


class InProcessFleet:
    """The ServingFleet named-lifecycle surface over IN-PROCESS
    engines: ``engine_factory(name)`` builds the engine a spawned
    replica wraps (an ``EngineReplica`` handle). Used by the fast
    controller tests and the smoke run, where process/socket overhead
    would drown the signal being measured."""

    def __init__(self, engine_factory):
        self._factory = engine_factory
        self._handles: Dict[str, object] = {}

    def spawn(self, name: Optional[str] = None) -> dict:
        from paddle_tpu_torch.serving.replica import EngineReplica
        if name is None:
            k = 0
            while f"replica{k}" in self._handles:
                k += 1
            name = f"replica{k}"
        cur = self._handles.get(name)
        if cur is not None and cur.alive():
            raise RuntimeError(f"replica {name!r} is still running")
        self._handles[name] = EngineReplica(self._factory(name),
                                            name=name)
        return {"name": name}

    def handle(self, name: str):
        return self._handles[name]

    def stop(self, name: str):
        h = self._handles.get(name)
        if h is not None:
            h.close()

    def kill_name(self, name: str):
        h = self._handles.get(name)
        if h is not None:
            h.kill()


class _HealState:
    """Per-name healing ledger."""

    def __init__(self, budget: RestartBudget, now: float):
        self.budget = budget
        self.launched_t = now       # current incarnation's birth
        self.next_attempt_t = 0.0   # backoff gate
        self.dead_seen = False      # this death already debited
        self.abandoned = False


class FleetController:
    """One control loop over (router, fleet). See module docstring.

    ``scale_up_queue``/``scale_up_burn``: either signal sustained for
    ``hysteresis_s`` triggers a scale-up (0 disables that signal).
    ``scale_down_idle_s``: a fully idle fleet sustained this long
    drains one surplus replica. ``wedge_timeout_s``: 0 disables the
    wedge hammer. ``clock`` is injectable for tests."""

    def __init__(self, router, fleet, *,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 heal: bool = True,
                 max_restarts: int = 3,
                 stable_window: float = 60.0,
                 backoff_base: float = 0.5,
                 backoff_cap: float = 15.0,
                 rewarm: bool = True,
                 rewarm_limit: int = 8,
                 scale_up_queue: int = 8,
                 scale_up_burn: float = 0.0,
                 scale_down_idle_s: float = 10.0,
                 hysteresis_s: float = 5.0,
                 spawn_budget: int = 6,
                 spawn_budget_window_s: float = 300.0,
                 wedge_timeout_s: float = 0.0,
                 clock=time.monotonic):
        self.router = router
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.heal = bool(heal)
        self.rewarm = bool(rewarm)
        self.rewarm_limit = int(rewarm_limit)
        self.scale_up_queue = int(scale_up_queue)
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.hysteresis_s = float(hysteresis_s)
        self.spawn_budget = int(spawn_budget)
        self.spawn_budget_window_s = float(spawn_budget_window_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self._clock = clock
        self._budget_kw = dict(
            max_restarts=int(max_restarts),
            stable_window=float(stable_window),
            backoff_base=float(backoff_base),
            backoff_cap=float(backoff_cap))
        now = self._clock()
        self._heal: Dict[str, _HealState] = {
            st.name: _HealState(RestartBudget(**self._budget_kw), now)
            for st in router._all}
        # wedge ledger: name -> (outstanding-ids snapshot, t of last
        # observed change)
        self._progress: Dict[str, tuple] = {}
        self._spawn_times: deque = deque()
        self._up_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._draining: set = set()
        # -- metrics: the ROUTER registry, prefixed fleet_* alongside
        # the aggregator's series (those are fleet_<engine metric>;
        # these controller names cannot collide)
        reg = router.metrics
        self._m_heals = reg.counter(
            "fleet_heal_total", "replica heal attempts, by result "
            "(healed = respawned + re-registered; failed = the spawn "
            "itself died, retried under backoff)")
        self._m_abandoned = reg.counter(
            "fleet_heal_abandoned_total", "replicas retired after "
            "their restart budget was exhausted (crash loop)")
        self._m_wedge = reg.counter(
            "fleet_wedge_kills_total", "alive-but-stuck replicas "
            "SIGKILLed by the wedge detector (healing follows)")
        self._m_scale = reg.counter(
            "fleet_scale_events_total", "autoscale decisions, by "
            "direction (up = replica spawned; down = drain begun)")
        self._m_scale_blocked = reg.counter(
            "fleet_scale_blocked_total", "scale-ups suppressed, by "
            "reason (budget = spawn tokens exhausted; max = at "
            "max_replicas)")
        self._m_target = reg.gauge(
            "fleet_target_replicas", "replicas the controller is "
            "steering toward (live + spawning - draining)")
        self._m_tokens = reg.gauge(
            "fleet_spawn_budget_remaining", "spawn tokens left in the "
            "current anti-flap window")
        self._m_target.set(len(router._all))
        self._m_tokens.set(self.spawn_budget)
        # the router /healthz grows a controller section
        router._controller_summary = self.summary

    # -- decision journal --------------------------------------------------
    def _decide(self, action: str, **detail):
        rec = {"t": time.time(), "actor": "fleet_controller",
               "action": action}
        rec.update(detail)
        _flight.default_flight_recorder().record(rec)
        logger.info("fleet_controller: %s %s", action, detail)

    # -- the loop ----------------------------------------------------------
    def step(self, now: Optional[float] = None):
        """One control iteration; drive alongside ``router.step()``."""
        now = self._clock() if now is None else now
        self._wedge_pass(now)
        self._heal_pass(now)
        self._scale_pass(now)
        self._drain_pass(now)
        live = sum(1 for st in self.router._all
                   if st.state != "dead"
                   and st.name not in self._draining)
        self._m_target.set(live)
        self._m_tokens.set(self._spawn_tokens_left(now))

    # -- wedge detection ---------------------------------------------------
    def _wedge_pass(self, now: float):
        if self.wedge_timeout_s <= 0:
            return
        for st in self.router._all:
            if st.state == "dead":
                self._progress.pop(st.name, None)
                continue
            ids = frozenset(st.outstanding.keys())
            prev = self._progress.get(st.name)
            if prev is None or prev[0] != ids:
                self._progress[st.name] = (ids, now)
                continue
            if ids and st.in_flight > 0 and \
                    now - prev[1] >= self.wedge_timeout_s:
                # alive but frozen: no result, ack, or error for the
                # whole window while holding work. Kill it — the dead
                # transport requeues its work and healing respawns it.
                self._m_wedge.inc()
                self._decide("wedge_kill", replica=st.name,
                             stuck_ops=len(ids),
                             stuck_s=round(now - prev[1], 3))
                try:
                    self.fleet.kill_name(st.name)
                except Exception:
                    pass
                try:
                    st.handle.close()
                except Exception:
                    pass
                self._progress.pop(st.name, None)

    # -- healing -----------------------------------------------------------
    def _heal_pass(self, now: float):
        if not self.heal:
            return
        for st in list(self.router._all):
            hs = self._heal.get(st.name)
            if hs is None:
                hs = self._heal[st.name] = _HealState(
                    RestartBudget(**self._budget_kw), now)
            if st.state != "dead":
                hs.dead_seen = False
                continue
            if hs.abandoned or st.name in self._draining:
                continue
            if not hs.dead_seen:
                # first sight of this death: debit the budget (a
                # long-stable incarnation refills it) and arm backoff
                hs.dead_seen = True
                hs.budget.note_failure(
                    stepped=True, uptime_s=now - hs.launched_t)
                if hs.budget.exhausted:
                    hs.abandoned = True
                    self._m_abandoned.inc()
                    self._decide("heal_abandoned", replica=st.name,
                                 restarts=hs.budget.restarts)
                    try:
                        self.router.remove_replica(st.name)
                    except RuntimeError:
                        # last decode replica: keep the corpse
                        # registered; a later manual heal can still
                        # replace it
                        hs.abandoned = False
                        hs.budget.reset()
                    continue
                hs.next_attempt_t = now + hs.budget.delay()
                self._decide(
                    "heal_scheduled", replica=st.name,
                    restarts=hs.budget.restarts,
                    delay_s=round(hs.next_attempt_t - now, 3))
                continue
            if now < hs.next_attempt_t:
                continue
            # attempt the respawn under the SAME name: the spill dir
            # hands over, the router keeps the slot
            try:
                self.fleet.spawn(st.name)
                handle = self.fleet.handle(st.name)
            except Exception as e:  # noqa: BLE001 — spawn died: retry
                self._m_heals.inc(result="failed")
                hs.budget.note_failure(stepped=False, uptime_s=0.0)
                if hs.budget.exhausted:
                    hs.abandoned = True
                    self._m_abandoned.inc()
                    self._decide("heal_abandoned", replica=st.name,
                                 restarts=hs.budget.restarts)
                    try:
                        self.router.remove_replica(st.name)
                    except RuntimeError:
                        hs.abandoned = False
                        hs.budget.reset()
                    continue
                hs.next_attempt_t = now + hs.budget.delay()
                self._decide("heal_failed", replica=st.name,
                             error=str(e)[:200],
                             retry_in_s=round(
                                 hs.next_attempt_t - now, 3))
                continue
            self.router.replace_replica(st.name, handle)
            hs.launched_t = now
            self._m_heals.inc(result="healed")
            rewarmed = 0
            if self.rewarm:
                try:
                    rewarmed = self.router.rewarm_replica(
                        st.name, limit=self.rewarm_limit)
                except Exception:  # noqa: BLE001 — rewarm is advisory
                    rewarmed = 0
            self._decide("healed", replica=st.name,
                         restarts=hs.budget.restarts,
                         rewarm_exports=rewarmed)

    # -- elastic capacity --------------------------------------------------
    def _spawn_tokens_left(self, now: float) -> int:
        while self._spawn_times and \
                now - self._spawn_times[0] > self.spawn_budget_window_s:
            self._spawn_times.popleft()
        return max(0, self.spawn_budget - len(self._spawn_times))

    def _live_decode(self):
        return [st for st in self.router._decode
                if st.state != "dead"
                and st.name not in self._draining]

    def _scale_pass(self, now: float):
        r = self.router
        want_up = ((self.scale_up_queue
                    and r.queue_depth >= self.scale_up_queue)
                   or (self.scale_up_burn
                       and r._slo_burn_rate() > self.scale_up_burn))
        if not want_up:
            self._up_since = None
        else:
            if self._up_since is None:
                self._up_since = now
            if now - self._up_since >= self.hysteresis_s:
                self._try_scale_up(now)
        # idle = nothing queued, nothing in flight anywhere
        idle = (r.queue_depth == 0
                and all(st.in_flight == 0 for st in r._all))
        if not idle:
            self._idle_since = None
        else:
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= self.scale_down_idle_s
                    and len(self._live_decode()) > self.min_replicas):
                self._begin_scale_down(now)

    def _try_scale_up(self, now: float):
        live = self._live_decode()
        if len(live) >= self.max_replicas:
            self._m_scale_blocked.inc(reason="max")
            self._up_since = now    # re-arm, don't spam
            return
        if self._spawn_tokens_left(now) <= 0:
            self._m_scale_blocked.inc(reason="budget")
            self._up_since = now
            return
        try:
            name = (self.fleet.allocate_name()
                    if hasattr(self.fleet, "allocate_name") else None)
            ep = self.fleet.spawn(name)
            name = ep["name"] if isinstance(ep, dict) else name
            handle = self.fleet.handle(name)
        except Exception as e:  # noqa: BLE001 — spawn died: not fatal
            self._decide("scale_up_failed", error=str(e)[:200])
            self._up_since = now
            return
        self.router.add_replica(handle)
        self._heal[name] = _HealState(
            RestartBudget(**self._budget_kw), now)
        self._spawn_times.append(now)
        self._up_since = now        # hysteresis restarts per replica
        self._m_scale.inc(direction="up")
        self._decide("scale_up", replica=name,
                     queue_depth=self.router.queue_depth,
                     burn=round(self.router._slo_burn_rate(), 3),
                     live=len(self._live_decode()))

    def _begin_scale_down(self, now: float):
        live = self._live_decode()
        # newest first: scale-down unwinds scale-up, and the seed
        # replicas keep the warmest caches
        victim = live[-1]
        self._draining.add(victim.name)
        self._idle_since = now
        self.router.begin_drain(victim.name)
        self._m_scale.inc(direction="down")
        self._decide("scale_down", replica=victim.name,
                     live=len(live) - 1)

    def _drain_pass(self, now: float):
        for name in list(self._draining):
            st = next((s for s in self.router._all
                       if s.name == name), None)
            if st is None:
                self._draining.discard(name)
                continue
            if st.state == "dead" or st.in_flight == 0:
                self._draining.discard(name)
                self._heal.pop(name, None)
                try:
                    self.router.remove_replica(name)
                except (KeyError, RuntimeError):
                    pass
                try:
                    self.fleet.stop(name)
                except Exception:
                    pass
                self._decide("drained", replica=name)

    # -- observability -----------------------------------------------------
    @staticmethod
    def _csum(metric) -> int:
        return int(sum(c.value for c in metric.series().values()))

    def summary(self) -> dict:
        now = self._clock()
        states = self.router.replica_states()
        return {
            "live": sum(1 for s in states.values() if s != "dead"),
            "min": self.min_replicas, "max": self.max_replicas,
            "draining": sorted(self._draining),
            "abandoned": sorted(n for n, h in self._heal.items()
                                if h.abandoned),
            "heals": self._csum(self._m_heals),
            "wedge_kills": self._csum(self._m_wedge),
            "scale_events": self._csum(self._m_scale),
            "spawn_tokens": self._spawn_tokens_left(now)}

    def health(self) -> dict:
        doc = dict(self.summary())
        doc["healthy"] = doc["live"] > 0
        return doc

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """The controller's own ``/healthz`` (+ the shared router
        registry's ``/metrics``); caller owns ``close()``."""
        from paddle_tpu_torch.observe.health import HealthServer
        return HealthServer(registry=self.router.metrics,
                            health_fn=self.health,
                            host=host, port=port)

"""Elastic gang supervision — the restart policy (counterpart of
``paddle_tpu/runtime/supervisor.py``).

The port holds what the serving fleet's control plane stands on:
:class:`RestartBudget`, the restart policy ``serving/autoscale.py``
heals replicas under. The gang contract's env names and state codes,
the supervisor's metrics, the heartbeat, the coordination-epoch helpers
and the gang ``Supervisor`` itself come with the multi-rank work that
reads them.
"""

from paddle_tpu_torch.runtime.master import DecorrelatedBackoff


class RestartBudget:
    """Restart policy for one supervised thing (a training gang, a
    serving replica): a budget of CONSECUTIVE unstable incarnations
    plus decorrelated-jitter backoff between relaunches.

    An incarnation that did real work (``stepped``) and then survived
    ``stable_window`` seconds refills the budget and cools the backoff
    when it eventually dies — routine independent preemptions spread
    over a job's lifetime must not exhaust a crash-loop guard. The
    budget is the supervisor's inline logic extracted so the fleet
    controller heals replicas under the exact same policy."""

    def __init__(self, max_restarts: int = 5,
                 stable_window: float = 300.0,
                 backoff_base: float = 0.5,
                 backoff_cap: float = 15.0):
        self.max_restarts = int(max_restarts)
        self.stable_window = float(stable_window)
        self.backoff = DecorrelatedBackoff(backoff_base, backoff_cap)
        self.restarts = 0

    def note_failure(self, *, stepped: bool, uptime_s: float):
        """Record one incarnation's death; call before consulting
        :attr:`exhausted` / :meth:`delay` for the relaunch."""
        if stepped and uptime_s >= self.stable_window:
            self.restarts = 0
            self.backoff.reset()
        self.restarts += 1

    @property
    def exhausted(self) -> bool:
        return self.restarts > self.max_restarts

    def delay(self) -> float:
        """Jittered sleep before the next relaunch."""
        return self.backoff.next()

    def reset(self):
        self.restarts = 0
        self.backoff.reset()

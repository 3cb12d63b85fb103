"""Training events (reference: python/paddle/v2/event.py — BeginPass,
EndPass, BeginIteration, EndIteration, TestResult delivered to the user's
event_handler)."""


class WithMetric:
    def __init__(self, evaluator):
        self.evaluator = evaluator

    @property
    def metrics(self):
        return self.evaluator.result() if self.evaluator else {}


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, gm=None):
        super().__init__(evaluator)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    """End of one trained batch. ``wall_time_s`` / ``examples_per_sec``
    carry the step's observability scalars (None when the trainer didn't
    measure them) — the same numbers observe.report() emits, so existing
    handlers can read them without touching the metrics registry."""

    def __init__(self, pass_id, batch_id, cost, evaluator=None,
                 wall_time_s=None, examples_per_sec=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.wall_time_s = wall_time_s
        self.examples_per_sec = examples_per_sec


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None):
        super().__init__(evaluator)
        self.cost = cost

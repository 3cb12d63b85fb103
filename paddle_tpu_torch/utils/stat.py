"""Named accumulating timers — the port's own copy of the parts of
``paddle_tpu/utils/stat.py`` that ``observe/trace.py`` uses (``Stat``,
``StatSet`` and the global set)."""

import threading
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Stat:
    name: str
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    min_s: float = field(default=float("inf"))

    def add(self, seconds: float):
        self.total_s += seconds
        self.count += 1
        self.max_s = max(self.max_s, seconds)
        self.min_s = min(self.min_s, seconds)


class StatSet:
    """Registry of named timers."""

    def __init__(self, name="global"):
        self.name = name
        self._stats: Dict[str, Stat] = {}
        self._lock = threading.Lock()

    def get(self, name) -> Stat:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = Stat(name)
            return self._stats[name]


global_stats = StatSet()

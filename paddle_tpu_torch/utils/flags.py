"""Runtime flags — the port's own copy of ``paddle_tpu/utils/flags.py``'s
typed registry with the flags the port reads (``profile``,
``flight_dir``); each is overridden by ``PADDLE_TPU_<NAME>`` in the
environment at import."""

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _FlagSpec:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).lower() in ("1", "true", "yes", "on")


class FlagRegistry:
    """Typed flag registry with env-var overrides (PADDLE_TPU_<NAME>)."""

    def __init__(self):
        self._specs: Dict[str, _FlagSpec] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "",
               parser: Optional[Callable] = None):
        if parser is None:
            if isinstance(default, bool):
                parser = _parse_bool
            elif isinstance(default, int):
                parser = int
            elif isinstance(default, float):
                parser = float
            else:
                parser = str
        with self._lock:
            self._specs[name] = _FlagSpec(name, default, help, parser)
            env = os.environ.get("PADDLE_TPU_" + name.upper())
            self._values[name] = parser(env) if env is not None else default
        return self

    def get(self, name, default=None):
        return self._values.get(name, default)

    def describe(self):
        return {n: (self._values[n], s.help) for n, s in self._specs.items()}


GLOBAL_FLAGS = FlagRegistry()
GLOBAL_FLAGS.define("profile", False, "open torch.profiler annotations "
                    "around trace scopes")
GLOBAL_FLAGS.define("flight_dir", "", "directory for flight-recorder "
                    "post-mortem artifacts (also: PADDLE_TPU_FLIGHT_DIR); "
                    "empty = working directory, and crash dumps beyond the "
                    "NaN tripwire stay off")

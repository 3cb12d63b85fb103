"""Runtime flags — the port's own copy of ``paddle_tpu/utils/flags.py``'s
typed registry with the flags the port reads (``profile``,
``flight_dir``, ``default_dtype``, ``compute_dtype``, ``seed``); each is
overridden by ``PADDLE_TPU_<NAME>`` in the environment at import."""

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

    def set(self, name, value):
        with self._lock:
            if name not in self._specs:
                raise KeyError(f"unknown flag {name!r}")
            spec = self._specs[name]
            self._values[name] = (spec.parser(value) if isinstance(value, str)
                                  else value)

    def describe(self):
        return {n: (self._values[n], s.help) for n, s in self._specs.items()}


GLOBAL_FLAGS = FlagRegistry()
GLOBAL_FLAGS.define("profile", False, "open torch.profiler annotations "
                    "around trace scopes")
GLOBAL_FLAGS.define("flight_dir", "", "directory for flight-recorder "
                    "post-mortem artifacts (also: PADDLE_TPU_FLIGHT_DIR); "
                    "empty = working directory, and crash dumps beyond the "
                    "NaN tripwire stay off")
GLOBAL_FLAGS.define("seed", 0, "global RNG seed; 0 derives from time")
GLOBAL_FLAGS.define("default_dtype", "float32", "parameter dtype")
GLOBAL_FLAGS.define("compute_dtype", "bfloat16", "matmul/conv compute dtype "
                    "(operands rounded to it, products accumulated in fp32)")

"""Host-side runtime (counterpart of ``paddle_tpu/runtime``): record IO
(``recordio``, with the native codec in ``native``), the data-dispatch
service and the serving fleet's replica processes (``master``), the
multi-process launcher (``launch``), the elastic training gang's
supervisor with its heartbeats and coordination epochs
(``supervisor``; its ``RestartBudget`` is also the policy the fleet
controller heals under) and fault injection (``chaos``).

Reference: the recordio chunk format consumed by the Go master
(go/master/service.go) and the task-dispatch service. The recordio
codec has a pure-Python implementation and a C++ one
(``runtime/native/``) loaded via ctypes when built.
"""

from paddle_tpu_torch.runtime import recordio  # noqa: F401

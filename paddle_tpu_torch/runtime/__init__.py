"""Host-side runtime (counterpart of ``paddle_tpu/runtime``): record IO
(``recordio``, with the native codec in ``native``), the data-dispatch
service and the serving fleet's replica processes (``master``), the
multi-process launcher (``launch``) and the restart policy the fleet
controller heals under (``supervisor.RestartBudget``).

Reference: the recordio chunk format consumed by the Go master
(go/master/service.go) and the task-dispatch service. The recordio
codec has a pure-Python implementation and a C++ one
(``runtime/native/``) loaded via ctypes when built.
"""

from paddle_tpu_torch.runtime import recordio  # noqa: F401

"""Aux subsystems: event logging and signal control.

Counterpart of ``sparknet_tpu/utils/``, with ``timing`` (``Timer`` on CUDA
events, ``time_layers``), ``log_parse`` (training logs to CSV tables),
``draw`` (nets to Graphviz DOT), ``plotting`` (log charts, matplotlib
imported in the call), ``profiling`` (``torch.profiler`` traces with the
layers' ranges) and ``op_profile`` (a traced step's device time by layer).
"""

from sparknet_tpu_torch.utils.event_log import EventLogger  # noqa: F401
from sparknet_tpu_torch.utils.signals import (  # noqa: F401
    SignalHandler,
    SolverAction,
    agree_action,
)
from sparknet_tpu_torch.utils.timing import Timer, time_layers  # noqa: F401

"""Telemetry of the port (counterpart of ``mlcomp_tpu/telemetry``), under
the JAX package's names:

- ``metrics`` — per-step series, counters and histograms whose hot-path
  cost is a host-side append; CUDA values come to the host at flush, in
  one stacked copy;
- ``spans`` — tracing spans, with the cross-process trace context;
- ``attribution`` — the per-step phase split (``step.phase.*``) and
  ``step.pipeline_efficiency``;
- ``compile_events`` — kernel builds as ``compile.backend_ms`` and the
  host-sync tripwire;
- ``device`` — the card's memory, the step's FLOPs (``FlopCounter``)
  and MFU;
- ``memory`` — the per-step memory timeline, the step's memory
  attribution and the postmortem flight recorder;
- ``deviceprof`` + ``trace_parse`` — sampled ``torch.profiler`` windows
  parsed into ``devtime.*`` series;
- ``profiler`` — on-demand traces toggled through
  ``/api/telemetry/profile``;
- ``export`` — OpenMetrics rendering behind ``GET /metrics``;
- ``watchdog`` — the health rules (stall, gang stall, step regression,
  straggler, HBM pressure, recompile storm, exposed comm) the supervisor
  tick evaluates into ``alert`` rows;
- ``slo`` — the SLO burn-rate engine: objectives, ``slo.*`` rows,
  ``slo-*`` alerts and the scoreboard (``slo_status``).

``collectives`` waits for A4 (ROADMAP.md): on one card there is no
collective to tally.
"""

from mlcomp_tpu_torch.telemetry.attribution import PHASES, StepAttribution
from mlcomp_tpu_torch.telemetry.compile_events import (
    COMPILE_EVENTS, CompileEventRecorder, HostSyncTripwire,
)
from mlcomp_tpu_torch.telemetry.device import (
    FlopCounter, device_memory_stats, mfu, record_device_stats,
)
from mlcomp_tpu_torch.telemetry.deviceprof import (
    DeviceProfiler, TorchTracer, close_live_profilers, persist_attribution,
    prune_profile_dirs,
)
from mlcomp_tpu_torch.telemetry.memory import (
    MemorySampler, build_postmortem, load_postmortem, memory_attribution,
    persist_memory_attribution, persist_postmortem, persist_run_snapshot,
)
from mlcomp_tpu_torch.telemetry.metrics import (
    Histogram, MetricRecorder, flush_live_recorders,
)
from mlcomp_tpu_torch.telemetry.profiler import (
    TaskProfiler, request_stop, request_trace, trace_status,
)
from mlcomp_tpu_torch.telemetry.spans import (
    flush_spans, get_trace_context, new_trace_id, record_span,
    set_trace_context, span,
)
from mlcomp_tpu_torch.telemetry.trace_parse import (
    parse_trace_dir, parse_trace_events, parse_trace_file,
)
from mlcomp_tpu_torch.telemetry.watchdog import Watchdog, WatchdogConfig
from mlcomp_tpu_torch.telemetry.slo import SloConfig, SloEngine, slo_status

__all__ = [
    'span', 'record_span', 'flush_spans', 'new_trace_id',
    'get_trace_context', 'set_trace_context',
    'MetricRecorder', 'Histogram', 'flush_live_recorders',
    'device_memory_stats', 'mfu', 'record_device_stats', 'FlopCounter',
    'TaskProfiler', 'request_trace', 'request_stop', 'trace_status',
    'StepAttribution', 'PHASES',
    'CompileEventRecorder', 'HostSyncTripwire', 'COMPILE_EVENTS',
    'MemorySampler', 'memory_attribution', 'persist_memory_attribution',
    'persist_run_snapshot', 'build_postmortem', 'persist_postmortem',
    'load_postmortem',
    'DeviceProfiler', 'TorchTracer', 'persist_attribution',
    'prune_profile_dirs', 'close_live_profilers',
    'parse_trace_dir', 'parse_trace_file', 'parse_trace_events',
    'Watchdog', 'WatchdogConfig', 'SloEngine', 'SloConfig', 'slo_status',
]

"""Telemetry of the port: metric series and latency histograms (flushed
to the DB), OpenMetrics rendering and trace spans (counterpart of
``mlcomp_tpu/telemetry``)."""

from mlcomp_tpu_torch.telemetry.metrics import MetricRecorder
from mlcomp_tpu_torch.telemetry.spans import (
    flush_spans, get_trace_context, new_trace_id, record_span,
    set_trace_context, span,
)

__all__ = ['MetricRecorder', 'span', 'record_span', 'flush_spans',
           'new_trace_id', 'get_trace_context', 'set_trace_context']

"""Telemetry of the port: in-memory latency histograms, OpenMetrics
rendering and trace spans (counterpart of ``mlcomp_tpu/telemetry``)."""

from mlcomp_tpu_torch.telemetry.metrics import MetricRecorder

__all__ = ['MetricRecorder']

"""Observability: the metrics registry, request tracing, the serving
engine's instrumentation and the NVFP4 quantization-health probe
(`obs/quant_probe.py`, imported on its own)."""

from repro_torch.obs.instrumentation import (NULL, Instrumentation,
                                             STAT_FLOAT_KEYS, STAT_INT_KEYS,
                                             STAT_KEYS, legacy_stats_dict)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry)
from repro_torch.obs.tracing import RequestTrace, Span, TraceSink

__all__ = [
    "NULL", "Instrumentation", "STAT_FLOAT_KEYS", "STAT_INT_KEYS",
    "STAT_KEYS", "legacy_stats_dict", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "default_registry", "RequestTrace", "Span",
    "TraceSink",
]

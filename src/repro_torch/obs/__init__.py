"""Telemetry copied from ``repro.obs``: tracer, metric registry, report
rendering (the JSONL/Perfetto exporters and the span validator wait)."""
from repro_torch.obs import report  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_RESERVOIR_CAP, Counter, Gauge, MetricRegistry, Reservoir)
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_TRACER, NullTracer, Tracer, resolve)

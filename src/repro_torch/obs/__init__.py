"""Telemetry copied from ``repro.obs``: tracer, metric registry, report
rendering, the JSONL / Perfetto exporters and the span validator."""
from repro_torch.obs import report  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    TICK_US, read_events, to_chrome_trace, write_events, write_metrics,
    write_perfetto)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_RESERVOIR_CAP, Counter, Gauge, MetricRegistry, Reservoir)
from repro_torch.obs.tracer import (  # noqa: F401
    NO_SPAN, NULL_TRACER, NullTracer, Tracer, current, resolve, using)
from repro_torch.obs.validate import (  # noqa: F401
    TraceInvariantError, validate_spans)

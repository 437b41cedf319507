"""Observability of the port: span tracer (``trace``; JSONL and Chrome
trace-event exports), labelled metrics (``metrics``; JSON snapshot,
Prometheus text and the process registry ``get_registry``) and measured
time against the H100's bound per kernel dispatch (``divergence``).
``launch.obs_report`` renders them."""
from .divergence import (DispatchKey, DispatchRecorder, DivergenceTracker,
                         key_from_context, modeled_bound_ms,
                         modeled_dispatch_bytes, price_dispatch)
from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, dump_telemetry, get_registry,
                      parse_prometheus_text, registry_scope, set_registry)
from .trace import (NOOP_SPAN, Span, Tracer, get_tracer, set_tracer,
                    tracer_scope)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Counter", "DispatchKey", "DispatchRecorder",
    "DivergenceTracker", "Gauge", "Histogram", "MetricsRegistry",
    "NOOP_SPAN", "Span", "Tracer", "dump_telemetry", "get_registry",
    "get_tracer", "key_from_context", "modeled_bound_ms",
    "modeled_dispatch_bytes", "parse_prometheus_text", "price_dispatch",
    "registry_scope", "set_registry", "set_tracer", "tracer_scope",
]

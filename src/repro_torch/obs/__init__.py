"""Ocean observability: span tracing, metrics registry, estimation-
accuracy telemetry. Zero external dependencies; tracing and the global
registry are off by default and the instrumented paths are allocation-
free when off. See ``docs/observability.md``.
"""
from .accuracy import (EstimationAccuracy, measure_accuracy,  # noqa: F401
                       record_decision)
from .metrics import (MetricsRegistry, active_registry,  # noqa: F401
                      install_registry)
from .trace import (NULL_SPAN, Span, Tracer, add_span, current,  # noqa: F401
                    enabled, install, span, tracing)

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "span", "add_span", "enabled",
    "install", "current", "tracing",
    "MetricsRegistry", "install_registry", "active_registry",
    "EstimationAccuracy", "measure_accuracy", "record_decision",
]

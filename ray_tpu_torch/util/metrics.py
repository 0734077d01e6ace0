"""User-defined metrics (reference: ray.util.metrics
Counter/Gauge/Histogram). Values export through the node's Prometheus
text endpoint (config metrics_export_port)."""

from ray_tpu_torch._private.metrics import Counter, Gauge, Histogram  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram"]

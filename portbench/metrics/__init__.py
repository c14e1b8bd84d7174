"""Metric readers, one file a metric, named as the metric is in
BENCHMARK.json; each has ``read(run) -> float | None``."""

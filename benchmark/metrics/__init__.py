"""One reader a metric: ``read(readings) -> float | None``; ``None`` when
the run has nothing to read, and the metric is left out of the line."""

"""Per-layer metrics, one reader a metric (``<metric>.py``): ``UNIT`` and
``read(data) -> number | None``.  ``data`` is what the cell's driver
returns (its "kind", window counts, the server's counts, the tracer); a
reader that finds nothing to read returns None and the metric is left out
of the run's line."""

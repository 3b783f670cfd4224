"""Per-layer metric readers, one module each, found by the metric's name
(``metrics/<name>.py``, else the name before its first dot).  Each has
``read(run) -> float | None``: None where the run holds nothing to read,
and the harness leaves the metric out of the line."""

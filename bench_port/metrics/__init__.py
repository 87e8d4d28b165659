"""One reader per per-layer metric, found by the metric's name
(registry.reader).  ``read(rec)`` takes the traced run's Records
(harness.Records) and returns the number, or None when the run holds
nothing to read."""

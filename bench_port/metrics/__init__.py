"""One reader a metric family (the metric's name before the first dot):
``read(record, name) -> float | None`` from the run's record
(``harness.Record``); None when there is nothing to read."""

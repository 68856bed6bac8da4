"""One reader a metric: ``read(record)`` gives the metric's value from a
run's record (``portbench.harness.Record``), or None where it finds nothing
to read; the harness then leaves the metric out of the result."""

"""Per-layer metric readers, one module a metric, found by the metric's
name; each ``read(ctx)`` returns the metric's value, or None where the run
gave it nothing to read."""

"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json. Each module's `read(view)` returns the metric's
value from a traced run's view (harness.View): host spans from the run's
untraced window, device operations from the traced tail that follows it.
It returns None where the run has nothing to read; the harness then leaves
the metric out of the line."""

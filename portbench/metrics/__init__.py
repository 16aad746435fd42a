"""One reader per metric of BENCHMARK.json: ``<name>.py`` with
``read(run) -> float | None`` over a ``portbench.run.Run``.  A reader
that finds nothing to read returns None, and the metric is left out of
the line."""

"""The port's benchmark harness: one cell of ``BENCHMARK.json`` per run."""

"""The port's benchmark: a harness driven by data (BENCHMARK.json at the
repository root, one file per configuration, cell and metric)."""

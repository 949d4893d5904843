"""The benchmark's general code: it finds every configuration, traffic mix,
per-layer metric, limit and reference by the name ``BENCHMARK.json`` gives
it, so a new cell needs new files and entries only (see ../README.md)."""

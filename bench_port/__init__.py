"""The port's benchmark: cells of BENCHMARK.json run through the
program's trainer entries (``python3 bench_port/run.py --help``)."""

"""The port's benchmark: BENCHMARK.json's cells, run by benchmark/run.py."""

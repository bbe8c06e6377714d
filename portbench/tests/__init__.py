"""CPU tests of the benchmark (run: python3 -m pytest portbench/tests)."""

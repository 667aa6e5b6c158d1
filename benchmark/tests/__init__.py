"""CPU tests of the benchmark (run them with ``python3 -m pytest benchmark/tests``)."""

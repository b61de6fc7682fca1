"""End-to-end metrics, one file each, named as in ``BENCHMARK.json``. Each
has ``read(run)``, the value from the run's host clock or memory reading."""

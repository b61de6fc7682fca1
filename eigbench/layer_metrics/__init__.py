"""Per-layer metrics, one file each, named as in ``BENCHMARK.json``. Each has
``read(run)``, which takes its number from the traced run's profile
(``run.trace``) and the results' counts, and returns None where it finds
nothing to read. The operation and byte counts and the peaks they use are
frozen here (``peaks.py`` and each file's own counts)."""

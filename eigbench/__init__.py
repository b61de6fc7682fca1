"""The benchmark of the PyTorch and CUDA port: ``python3 eigbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, with its cells in ``BENCHMARK.json``."""

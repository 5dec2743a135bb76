"""The benchmark of the PyTorch and CUDA port: ``python3 port_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of
a checkout (PERF.md, BENCHMARK.json)."""

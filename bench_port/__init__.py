"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell runs
as ``python bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``BENCHMARK.json`` and ``harness.py``)."""

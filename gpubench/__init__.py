"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA GPUs.

``python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. See ``gpubench/README.md``.
"""

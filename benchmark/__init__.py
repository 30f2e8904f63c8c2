"""The benchmark of the PyTorch and CUDA port (distributedmnist_tpu_torch).

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the card and
prints one JSON line. Everything a cell needs is found by name: its
configuration in configs/, its traffic mix in traffic/ (a data file and
the driver it names), its correctness limits in workloads/, and each
per-layer metric's reader in metrics/.
"""

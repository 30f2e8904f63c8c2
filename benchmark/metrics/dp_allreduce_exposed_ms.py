"""NCCL time a step that no compute kernel covers
(harness/readers.py)."""

from benchmark.harness import readers

read = readers.allreduce_exposed_ms

"""The step's kernels' share of their roofline (harness/readers.py)."""

from benchmark.harness import readers

read = readers.roofline_pct

"""Launches a training step, over the ranks (harness/readers.py)."""

from benchmark.harness import readers

read = readers.launches_per_step

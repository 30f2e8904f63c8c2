"""Launches a training step (harness/readers.py)."""

from benchmark.harness import readers

read = readers.launches_per_step

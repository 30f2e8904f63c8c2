"""The training step's share of each card's float32 peak, over the ranks
(harness/readers.py)."""

from benchmark.harness import readers

read = readers.mfu

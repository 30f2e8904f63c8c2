"""The training step's share of the card's float32 peak
(harness/readers.py)."""

from benchmark.harness import readers

read = readers.mfu

"""The cards' idle share of the traced slice, over the ranks
(harness/readers.py)."""

from benchmark.harness import readers

read = readers.idle_pct

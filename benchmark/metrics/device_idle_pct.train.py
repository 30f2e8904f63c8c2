"""The card's idle share of the traced slice (harness/readers.py)."""

from benchmark.harness import readers

read = readers.idle_pct

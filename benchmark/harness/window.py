"""Window arithmetic: all the work over all the time of the window.

No metric here is a median of chunks or of windows: a rate is the work
completed in the window over the window's whole length.
"""

from __future__ import annotations


def rate(work: float, t0: float, t1: float, chips: int = 1) -> float:
    """work / (t1 - t0) / chips."""
    if t1 <= t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    return work / (t1 - t0) / chips

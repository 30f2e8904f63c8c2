"""The window arithmetic: all the work over all the time."""

import pytest

from benchmark.harness import window


def test_rate_is_work_over_whole_window():
    assert window.rate(1000, 10.0, 12.0) == 500.0
    assert window.rate(1000, 10.0, 12.0, chips=4) == 125.0
    with pytest.raises(ValueError):
        window.rate(1, 2.0, 2.0)

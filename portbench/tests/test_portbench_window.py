"""The window's arithmetic on a fake clock."""

import numpy as np
import pytest

from portbench.window import Window, percentile


def test_rate_over_the_whole_window():
    w = Window()
    # four batches of 16 handed at 0, 1, 2, 3 s; results at 2.5, 3, 4, 9 s
    for t in (0.0, 1.0, 2.0, 3.0):
        w.hand(t, 16)
    for t in (2.5, 3.0, 4.0, 9.0):
        w.result(t, 16)
    assert w.attempted == w.tiles == 64
    assert w.seconds == 9.0
    assert w.tiles_per_s() == pytest.approx(64 / 9.0)
    assert w.latencies_ms() == pytest.approx([2500, 2000, 2000, 6000])


def test_tail_over_all_batches():
    rng = np.random.default_rng(3)
    lat = list(rng.exponential(30.0, 853))
    w = Window()
    for i, x in enumerate(lat):
        w.hand(float(i), 16)
        w.result(i + x / 1e3, 16)
    assert percentile(w.latencies_ms(), 95) == pytest.approx(
        np.percentile(lat, 95), rel=1e-9)
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        percentile([], 95)

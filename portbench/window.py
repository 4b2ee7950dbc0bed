"""The measured window's arithmetic, on any clock.

A window opens when its first batch is handed to the engine (the feeding
iterator yields it) and closes when the engine yields the last batch's
result. ``tiles_per_s`` is every tile whose result reached the host over
the whole window; a batch's latency runs from its hand-over to its result
being yielded, and the tail is taken over all of the window's batches.
The engine returns batches in the order they were handed over.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between the two
    nearest ranks (numpy's default): rank q/100·(n − 1) of the sorted
    values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = q / 100.0 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


class Window:
    """Hand-over and result times of one window's batches."""

    def __init__(self):
        self.handed: list = []          # (time, tiles) a batch
        self.returned: list = []        # (time, tiles) a batch

    def hand(self, t: float, tiles: int):
        self.handed.append((t, tiles))

    def result(self, t: float, tiles: int):
        self.returned.append((t, tiles))

    @property
    def attempted(self) -> int:
        return sum(n for _, n in self.handed)

    @property
    def tiles(self) -> int:
        return sum(n for _, n in self.returned)

    @property
    def seconds(self) -> float:
        return self.returned[-1][0] - self.handed[0][0]

    def tiles_per_s(self) -> float:
        return self.tiles / self.seconds

    def latencies_ms(self) -> list:
        return [(r - h) * 1e3 for (h, _), (r, _) in zip(self.handed,
                                                          self.returned)]

"""h2d_mb.serve (MB, layer: batch boundary; moves serve_points_per_s): MB that
from_numpy ships to the card a call, by its own counters (from_numpy.bytes /
from_numpy.calls)."""
from benchmark.harness.spans import h2d_mb


def read(run):
    return h2d_mb(run, train=False)

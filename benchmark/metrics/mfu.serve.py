"""mfu.serve (%, layer: model step; moves serve_points_per_s): model FLOPs of
the window's requests over the window, as a share of the bf16 peak."""
from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, train=False)

"""mfu.train (%, layer: model step; moves train_points_per_s): model FLOPs of
the window's steps over the window, as a share of the bf16 peak."""
from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, train=True)

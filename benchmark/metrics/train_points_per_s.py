"""train_points_per_s (points/s, end to end): valid level-0 points of all
training steps completed in the window over the window's seconds."""
from benchmark.harness.readers import points_per_s


def read(run):
    return points_per_s(run, train=True)

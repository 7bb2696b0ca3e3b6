"""h2d_ms.train (ms, layer: batch boundary; moves train_points_per_s): device
time of host-to-device copies a step, traced."""
from benchmark.harness.readers import h2d_ms


def read(run):
    return h2d_ms(run, train=True)

"""h2d_ms.serve (ms, layer: batch boundary; moves serve_points_per_s): device
time of host-to-device copies a request, traced."""
from benchmark.harness.readers import h2d_ms


def read(run):
    return h2d_ms(run, train=False)

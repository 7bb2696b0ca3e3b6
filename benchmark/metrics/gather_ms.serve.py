"""gather_ms.serve (ms, layer: model ops; moves serve_points_per_s): device
time of the kernels launched inside spt.gather spans (the gathers, forward
and backward) a request, traced."""
from benchmark.harness.spans import gather_ms


def read(run):
    return gather_ms(run, train=False)

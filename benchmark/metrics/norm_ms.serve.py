"""norm_ms.serve (ms, layer: model; moves serve_points_per_s): device
time of the events launched inside spt.norm spans (GraphNorm's forward:
its kernels, or its PyTorch path's sums, gathers and casts) a request,
traced."""
from benchmark.harness.norm_spans import norm_ms


def read(run):
    return norm_ms(run)

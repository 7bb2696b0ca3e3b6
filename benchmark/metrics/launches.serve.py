"""launches.serve (launches/req, layer: model; moves serve_points_per_s):
device kernel launches a request, traced."""
from benchmark.harness.readers import launches


def read(run):
    return launches(run, train=False)

"""launches.train (launches/step, layer: model; moves train_points_per_s):
device kernel launches a step, traced."""
from benchmark.harness.readers import launches


def read(run):
    return launches(run, train=True)

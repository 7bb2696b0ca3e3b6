"""batch_host_ms.train (ms, layer: batch boundary; moves train_points_per_s):
host time in spt.batch spans (from_numpy: strip, cast, pin, copies) a step,
traced."""
from benchmark.harness.spans import batch_host_ms


def read(run):
    return batch_host_ms(run, train=True)

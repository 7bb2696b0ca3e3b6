"""batch_host_ms.serve (ms, layer: batch boundary; moves serve_points_per_s):
host time in spt.batch spans (from_numpy: strip, cast, pin, copies) a
request, traced."""
from benchmark.harness.spans import batch_host_ms


def read(run):
    return batch_host_ms(run, train=False)

"""affinity_ms.serve (ms, layer: edge-affinity head; moves serve_points_per_s):
device time of the events launched inside spt.affinity spans (the head and
its gathers) a request, traced."""
from benchmark.harness.panoptic_spans import affinity_ms


def read(run):
    return affinity_ms(run)

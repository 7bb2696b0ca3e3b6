"""partition_host_ms.serve (ms, layer: instance partition; moves
serve_points_per_s): host time in spt.partition spans (the host partition of
level 1 and the instance classes) a request, traced."""
from benchmark.harness.panoptic_spans import partition_host_ms


def read(run):
    return partition_host_ms(run)

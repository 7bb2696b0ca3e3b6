"""partition_edges.serve (edges/call, layer: instance partition; moves
serve_points_per_s): instance-graph edges a partition, by the program's own
counters (instance_partition.edges / instance_partition.calls)."""
from benchmark.harness.panoptic_spans import partition_edges


def read(run):
    return partition_edges(run)

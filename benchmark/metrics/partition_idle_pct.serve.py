"""partition_idle_pct.serve (%, layer: instance partition; moves
serve_points_per_s): the share of the traced window in which the card is
idle while the host is in an spt.partition span."""
from benchmark.harness.panoptic_spans import partition_idle_pct


def read(run):
    return partition_idle_pct(run)

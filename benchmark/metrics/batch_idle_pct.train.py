"""batch_idle_pct.train (%, layer: batch boundary; moves train_points_per_s):
share of the traced window with the card idle while the host is in a
spt.batch span."""
from benchmark.harness.spans import batch_idle_pct


def read(run):
    return batch_idle_pct(run, train=True)

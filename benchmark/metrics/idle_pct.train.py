"""idle_pct.train (%, layer: device; moves train_points_per_s): share of the
traced window with no kernel or copy on the card."""
from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run, train=True)

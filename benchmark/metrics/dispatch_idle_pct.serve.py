"""dispatch_idle_pct.serve (%, layer: model; moves serve_points_per_s): share
of the traced window with the card idle while the host is in another spt.*
span (the model step's Python and dispatch)."""
from benchmark.harness.spans import dispatch_idle_pct


def read(run):
    return dispatch_idle_pct(run, train=False)

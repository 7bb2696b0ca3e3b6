"""k2_roofline.serve (%, layer: kernels; moves serve_points_per_s): the
least time of the traced requests' K2 launches
(`dense_attention_rpe_kernel`, ops/attention_rpe.py), each at its level's
valid nodes and slots, over their device time."""
from benchmark.harness.readers import roofline

KERNEL = r'\bdense_attention_rpe_kernel\b'


def read(run):
    return roofline(run, False, 'K2', KERNEL)

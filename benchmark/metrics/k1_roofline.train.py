"""k1_roofline.train (%, layer: kernels; moves train_points_per_s): the
least time of the traced steps' K1 launches (`dense_attention_kernel`,
ops/attention.py), each at its level's valid nodes and slots with a
query per edge, over their device time."""
from benchmark.harness.readers import roofline

KERNEL = r'\bdense_attention_kernel\b'


def read(run):
    return roofline(run, True, 'K1', KERNEL)

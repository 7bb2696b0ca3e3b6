"""Histogram helpers: a copy of the JAX package's `utils/histogram.py`."""
import numpy as np

__all__ = ['atomic_to_histogram']


def atomic_to_histogram(item, cluster, n_bins):
    """Aggregate per-element integer labels (or label histograms) into
    per-cluster histograms of `n_bins` columns. Labels outside
    [0, n_bins) count into the LAST bin (void)."""
    item = np.asarray(item)
    cluster = np.asarray(cluster)
    n_clusters = int(cluster.max()) + 1 if cluster.size else 0
    if item.ndim == 2:
        out = np.zeros((n_clusters, item.shape[1]), dtype=np.int64)
        np.add.at(out, cluster, item.astype(np.int64))
        return out
    lab = item.astype(np.int64).copy()
    lab[(lab < 0) | (lab >= n_bins)] = n_bins - 1
    out = np.zeros((n_clusters, n_bins), dtype=np.int64)
    np.add.at(out, (cluster, lab), 1)
    return out

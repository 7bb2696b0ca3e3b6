"""Inference on a padded batch: forward, level-1 argmax, predictions
in NAG order. Counterpart of `level1_node_id`, `to_nag_order` and the
forward of `infer_nag` in `superpoint_transformer_tpu/inference.py`,
without the host NAG pipeline (the batch arrives padded)."""
import numpy as np
import torch

__all__ = ['level1_node_id', 'to_nag_order', 'infer_batch']


def level1_node_id(batch, n1):
    """Pre-sort NAG row of each batch-order level-1 node (the host
    path sorts levels by parent). Identity when the batch carries no
    node ids."""
    if batch.level1_node_id is None:
        return np.arange(n1)
    return batch.level1_node_id[:n1]


def to_nag_order(row_batch, nid):
    """Scatter batch-order rows back to NAG order
    (out[nid[r]] = row_batch[r]); rows may be 1-D or 2-D. `nid` must be
    a permutation of range(len(row_batch)), or rows of the output would
    be left uninitialized."""
    nid = np.asarray(nid)
    if nid.shape[0] != row_batch.shape[0] or not np.array_equal(
            np.sort(nid), np.arange(nid.shape[0])):
        raise ValueError('to_nag_order: node ids are not a permutation of '
                         f'range({row_batch.shape[0]})')
    out = np.empty_like(row_batch)
    out[nid] = row_batch
    return out


def infer_batch(model, batch):
    """Level-1 class predictions of a `SemanticSegmentationModel` on a
    padded batch (`data.padded.from_numpy`), as a host int64 array in
    the NAG's level-1 row order. One device-to-host copy."""
    with torch.inference_mode():
        logits = model(batch)
        n1 = batch[1].num_nodes
        pred = logits[0][:n1].argmax(1).cpu().numpy()
    return to_nag_order(pred, level1_node_id(batch, n1))

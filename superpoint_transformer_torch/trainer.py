"""The panoptic validation epoch: `validate_panoptic` and `_cat_instance`,
counterparts of those in `superpoint_transformer_tpu/trainer.py`. The
`Trainer` class (fit and validation loops, loggers, checkpoints) is not
ported.
"""
import numpy as np

from .data.csr import InstanceData
from .data.padded import from_numpy
from .metrics.mean_average_precision import MeanAveragePrecision3D
from .metrics.panoptic import PanopticQuality3D
from .models.panoptic import (grid_search_panoptic_partition,
                              instance_partition)
from .transforms.prepare import prepare_batch

__all__ = ['validate_panoptic']


def _numpy(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.cpu().numpy()


def validate_panoptic(task, loader, batch_cfg, num_classes,
                      stuff_classes=(), grid_search=False, settings=None,
                      pq=None, ap=None):
    """Panoptic validation epoch of the `PanopticTask` `task`, on the
    device of its model: per batch of NAGs from `loader`, the evaluation
    forward, then on the host the instance partition of the predicted
    level-1 logits and edge affinities, matched against the gt
    InstanceData overlaps to accumulate PQ and mAP.

    Batches are prepared with `batch_cfg` (`instance=True`: the level-1
    instance graph) in evaluation mode and moved with their label
    histograms (`from_numpy(..., train=True)`), which the loss and its
    edge weights need; the NAGs carry `obj` InstanceData at level 1.
    Returns dict(pq, sq, rq, map_50, ...). `grid_search=True` searches
    the partition settings on the FIRST batch and reuses the best ones
    for the rest. `pq` and `ap` are accumulators to continue.
    """
    if pq is None:
        pq = PanopticQuality3D(num_classes, stuff_classes=stuff_classes)
    if ap is None:
        ap = MeanAveragePrecision3D(num_classes,
                                    stuff_classes=stuff_classes)
    if settings is None:
        settings = dict(regularization=10.0, x_weight=5e-2, cutoff=1)
    device = next(task.model.parameters()).device
    compute_dtype = task.model.net.compute_dtype
    first = True
    out_diag = {}
    for nags in loader:
        host = prepare_batch(nags, batch_cfg, train=False)
        batch = from_numpy(host, device, compute_dtype, train=True)
        out = task.eval_step(batch)
        lvl1 = batch[1]
        n1 = int(lvl1.num_nodes)
        logits = _numpy(out['logits_level1'])[:n1]
        ea = out.get('edge_affinity_logits')
        if ea is None or lvl1.obj_edge_index is None:
            continue
        emask = _numpy(lvl1.obj_edge_mask)
        ei = _numpy(lvl1.obj_edge_index)[:, emask]
        ea = _numpy(ea)[emask]
        pos = _numpy(lvl1.pos)[:n1]
        sizes = _numpy(lvl1.node_size)[:n1] \
            if lvl1.node_size is not None else None
        # gt overlaps from the host NAGs (level-1 InstanceData)
        objs = [nag[1].get('obj') for nag in nags]
        if any(o is None for o in objs):
            continue
        obj = objs[0] if len(objs) == 1 else _cat_instance(objs)
        # the batch's level 1 is sorted by parent: the logits, positions
        # and edges above are in batch order, `obj` in the host NAGs'
        # order. Reindex the gt overlaps into batch order.
        if batch.level1_node_id is not None:
            nid = batch.level1_node_id[:n1]
            if not np.array_equal(nid, np.arange(n1)):
                obj = obj[nid][0]

        if grid_search and first:
            settings, _, _ = grid_search_panoptic_partition(
                pos, logits, ei, ea, obj, num_classes,
                node_size=sizes, stuff_classes=stuff_classes)
            first = False
        obj_index = instance_partition(
            pos, logits, ei, ea, node_size=sizes,
            stuff_classes=stuff_classes, num_classes=num_classes,
            **settings)
        # diagnostics: how many instances the partition produced and how
        # well the predicted affinities separate the gt graph
        out_diag['n_pred_instances'] = (
            out_diag.get('n_pred_instances', 0)
            + int(obj_index.max()) + 1)
        if lvl1.obj_edge_affinity is not None:
            # counts accumulate across batches; fractions after the loop
            tgt = _numpy(lvl1.obj_edge_affinity)[emask]
            pred_pos = ea > 0.0
            gt_pos = tgt > 0.5
            out_diag['_ea_correct'] = (out_diag.get('_ea_correct', 0)
                                       + int((pred_pos == gt_pos).sum()))
            out_diag['_ea_gt_pos'] = (out_diag.get('_ea_gt_pos', 0)
                                      + int(gt_pos.sum()))
            out_diag['_ea_total'] = (out_diag.get('_ea_total', 0)
                                     + int(gt_pos.shape[0]))
        merged = obj.merge(obj_index)
        n_inst = int(obj_index.max()) + 1
        pred_sem = np.zeros(n_inst, np.int64)
        scores = np.zeros(n_inst)
        for i_ in range(n_inst):
            m = obj_index == i_
            s = logits[m].sum(0)
            pred_sem[i_] = s.argmax()
            p = np.exp(s - s.max())
            scores[i_] = (p / p.sum()).max()
        pq.update_from_instance_data(merged, pred_sem)
        ap.update_from_instance_data(merged, pred_sem, scores)
    out = pq.compute()
    out.update({f'map_{k}' if not k.startswith('map') else k: v
                for k, v in ap.compute().items()
                if k in ('map', 'map_50', 'map_25', 'mar')})
    # edge-affinity fractions from the accumulated counts
    ea_tot = out_diag.pop('_ea_total', 0)
    ea_correct = out_diag.pop('_ea_correct', 0)
    ea_gt_pos = out_diag.pop('_ea_gt_pos', 0)
    if ea_tot:
        out_diag['edge_affinity_acc'] = ea_correct / ea_tot
        out_diag['edge_affinity_gt_pos_frac'] = ea_gt_pos / ea_tot
    out.update(out_diag)
    out['settings'] = settings
    return out


def _cat_instance(objs):
    """Batch collation for gt overlaps (InstanceData.cat)."""
    return InstanceData.cat(objs)

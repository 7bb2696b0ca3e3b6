"""SuperCluster on any preprocessed room; counterpart of
`superpoint_transformer_tpu/utils/supercluster_demo.py`. Runs the whole
panoptic loop (edge-affinity training, instance cut pursuit, PQ grid
search, PQ/SQ/RQ) with pseudo ground-truth instances built from
connected components of same-label voxels (`utils/pseudo_instances.py`).
Reference loop: src/models/panoptic.py:443-1051.
"""
import dataclasses
import time

import numpy as np
import torch

__all__ = ['run_supercluster_demo']


def run_supercluster_demo(nag, steps=600, crops=4, seed=0,
                          num_classes=13, task=None, log=print,
                          pool=24, edge_affinity_loss_weights=None,
                          experiment='panoptic/s3dis', device='cuda'):
    """Train a `PanopticTask` on radius crops of `nag` (semantic heads and
    the edge-affinity head on the level-1 instance graph), then run the
    instance partition and the PQ grid search on the whole room. Returns
    PQ/SQ/RQ, precision/recall and mAP, the cross-oracle PQs, and the
    pseudo-instance panoptic oracle's ceiling.

    `task` trains from its current weights on its model's device.
    Without it, the task of `configs/` `experiment=<experiment>` is built
    on `device`, the card unless the caller asks for the CPU, its weights
    drawn from `torch.Generator().manual_seed(seed)`. The model's dropout
    stream restarts from `seed + 1`. `edge_affinity_loss_weights`
    overrides the task's 4-case edge weights: the pseudo-instance graph
    is mostly positive (~92% of its edges join one object), and without
    upweighting the negative cases the affinity head degenerates to
    all-positive (the reference's knob, src/models/panoptic.py:726-758).
    Training cycles through a pool of `pool` batches prepared once and
    kept on the device, and the losses are read back once, at the end."""
    from .pseudo_instances import add_pseudo_instances
    from ..data.padded import from_numpy
    from ..metrics.oracle import panoptic_segmentation_oracle
    from ..nn.mlp import init_weights
    from ..trainer import validate_panoptic
    from ..transforms.prepare import BatchConfig, discover_caps, prepare_batch

    nag, info = add_pseudo_instances(nag.clone(), num_classes=num_classes)
    log(f'pseudo-instances: {info}')

    if task is None:
        task = _default_panoptic_task(steps, crops, num_classes,
                                      experiment=experiment, device=device)
        init_weights(task.model, torch.Generator().manual_seed(seed))
    if edge_affinity_loss_weights is not None:
        task.edge_affinity_loss_weights = tuple(
            float(w) for w in edge_affinity_loss_weights)
    stuff = tuple(getattr(task, 'stuff_classes', ()) or ())
    dev = next(task.model.parameters()).device
    compute_dtype = task.model.net.compute_dtype

    cfg = BatchConfig(instance=True)
    rng = np.random.default_rng(seed)
    probe = [[nag] * crops for _ in range(3)]
    cfg_train = discover_caps(probe, cfg, train=True,
                              rng=np.random.default_rng(seed))
    cfg_eval = dataclasses.replace(
        cfg, sample_graph_r=-1, sample_segment_ratio=0,
        rgb_autocontrast=0, rgb_drop=0)

    pool = max(1, min(pool, steps))
    batches = [from_numpy(prepare_batch([nag] * crops, cfg_train,
                                        train=True, rng=rng),
                          dev, compute_dtype, train=True)
               for _ in range(pool)]
    rng_dropout = getattr(task.model.net, 'dropout_rng', None)
    if rng_dropout is not None:
        rng_dropout.manual_seed(seed + 1)

    t0 = time.time()
    loss_first = loss_last = None
    for s in range(steps):
        loss_last = task.train_step(batches[s % pool])['loss']
        if s == 0:
            loss_first = loss_last
    losses = torch.stack([loss_first, loss_last]).float().cpu().tolist() \
        if steps else [None, None]

    # whole-room panoptic validation: partition, grid search and PQ
    pm = validate_panoptic(task, [[nag]], cfg_eval, num_classes,
                           stuff_classes=stuff, grid_search=True)
    pm.update(_cross_oracle_pq(task, nag, cfg_eval, num_classes, stuff))
    oracle = panoptic_segmentation_oracle(nag[1].obj, num_classes,
                                          stuff_classes=stuff)

    out = {k: v for k, v in pm.items() if isinstance(v, (int, float))}
    out.update({
        'oracle_pq': float(oracle['pq']),
        'oracle_sq': float(oracle.get('sq', float('nan'))),
        'oracle_rq': float(oracle.get('rq', float('nan'))),
        'n_pseudo_instances': info['n_instances'],
        'loss_first': losses[0], 'loss_last': losses[-1],
        'steps': steps, 'crops': crops,
        'settings': pm.get('settings'),
        'wall_sec': time.time() - t0,
    })
    return out


def _cross_oracle_pq(task, nag, cfg_eval, num_classes, stuff):
    """PQ of the instance partition with each trained input swapped for
    its oracle: (trained logits + oracle affinities) and (oracle logits +
    trained affinities). Both oracles reach the panoptic ceiling, so
    these two cells attribute the gap. Also the level-1 semantic mIoU and
    OA of the trained logits."""
    from ..data.padded import from_numpy
    from ..metrics.semantic import ConfusionMatrix
    from ..models.panoptic import grid_search_panoptic_partition
    from ..transforms.prepare import prepare_batch

    dev = next(task.model.parameters()).device
    batch = from_numpy(prepare_batch([nag], cfg_eval, train=False), dev,
                       task.model.net.compute_dtype, train=True)
    out = task.eval_step(batch)
    lvl1 = batch[1]
    n1 = int(lvl1.num_nodes)
    logits = out['logits_level1'][:n1].float().cpu().numpy()
    emask = lvl1.obj_edge_mask.cpu().numpy()
    ei = lvl1.obj_edge_index.cpu().numpy()[:, emask]
    ea = out['edge_affinity_logits'].float().cpu().numpy()[emask]
    pos = lvl1.pos[:n1].float().cpu().numpy()
    sizes = (lvl1.node_size[:n1].cpu().numpy()
             if lvl1.node_size is not None else None)
    # the batch's level 1 is sorted by parent: everything above is in
    # batch order; reindex the NAG-order gt (obj, y) into it
    nid = (batch.level1_node_id[:n1]
           if batch.level1_node_id is not None else np.arange(n1))

    obj = nag[1].obj[nid][0]
    maj_obj, _, maj_y = obj.major(num_classes=num_classes)
    maj_obj, maj_y = np.asarray(maj_obj), np.asarray(maj_y)
    valid = maj_y < num_classes
    o_logits = np.full((n1, num_classes), -10.0, np.float32)
    o_logits[np.arange(n1)[valid], maj_y[valid]] = 10.0
    same = (maj_obj[ei[0]] == maj_obj[ei[1]]) & valid[ei[0]] & valid[ei[1]]
    o_ea = np.where(same, 10.0, -10.0).astype(np.float32)

    res = {}
    if nag[1].y is not None:
        y1 = np.asarray(nag[1].y)[nid]
        if y1.ndim == 2:
            y1 = y1[:, :num_classes]   # label histograms
        cm = ConfusionMatrix(num_classes)
        cm.update(logits.argmax(-1), y1)
        res['semantic_miou_level1'] = float(cm.miou())
        res['semantic_oa_level1'] = float(cm.oa())
    for name, lg, aff in (
            ('pq_trained_logits_oracle_affinity', logits, o_ea),
            ('pq_oracle_logits_trained_affinity', o_logits, ea)):
        _, metrics, obj_index = grid_search_panoptic_partition(
            pos, lg, ei, aff, obj, num_classes, node_size=sizes,
            stuff_classes=stuff)
        res[name] = float(metrics['pq'])
        res[name.replace('pq_', 'n_inst_')] = int(obj_index.max()) + 1
    return res


def _default_panoptic_task(steps, crops, num_classes,
                           experiment='panoptic/s3dis', device='cuda'):
    """The SuperCluster task as the CLI builds it (configs/train.yaml +
    experiment=panoptic/s3dis, or its with-stuff variant: ceiling, floor
    and wall merged to one segment per class, reference
    utils/instance.py:649-672), on `device`."""
    from ..config.loader import load_config
    from ..experiment import build_task
    from ..train import CONFIG_DIR
    cfg = load_config(CONFIG_DIR, 'train', [f'experiment={experiment}'])
    return build_task(cfg, total_steps=steps, num_graphs=crops,
                      device=device)

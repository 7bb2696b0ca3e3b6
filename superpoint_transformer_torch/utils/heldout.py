"""Held-out generalization on any preprocessed room; counterpart of
`superpoint_transformer_tpu/utils/heldout.py`.

A spatial split of one room: train the flagship on radius crops of ONE
half, evaluate the whole OTHER half. This measures generalization to
unseen geometry (the reference's headline protocol is 6-fold
cross-validation over held-out areas, reference README.md:66,
src/utils/semantic.py:73).
"""
import dataclasses
import time

import numpy as np
import torch

__all__ = ['split_nag_spatially', 'run_heldout']


def split_nag_spatially(nag, frac=0.5, axis=0, gap=0.0):
    """Split a NAG into two NAGs at the `frac` quantile of the level-1
    segment centroids along `axis` (superpoints stay whole: the
    partition, its horizontal graphs and parent levels are re-indexed by
    `NAG.select` on each side). `gap` drops a band of that width (in
    meters) on each side of the cut, so the halves share no touching
    geometry."""
    x = np.asarray(nag[1].pos)[:, axis]
    cut = float(np.quantile(x, frac))
    lo = nag.select(1, np.where(x < cut - gap)[0])
    hi = nag.select(1, np.where(x >= cut + gap)[0])
    return lo, hi


def run_heldout(train_nag, eval_nag, steps=1000, crops=4, seed=0,
                num_classes=13, eval_every=0, task=None, cfg=None,
                log=print, pool=48, device='cuda'):
    """Train the flagship on radius crops of `train_nag`, evaluate it on
    the whole `eval_nag`. Returns a dict with the held-out mIoU / OA /
    mAcc, the eval half's partition-oracle ceiling (every segment
    predicts its majority class: the most the model can reach) and the
    first and last train losses.

    `task` (a `SemanticTask`, e.g. with weights loaded) trains from its
    current weights on its model's device. Without it, the flagship task
    of `configs/` (`experiment=semantic/s3dis`) is built on `device`, the
    card unless the caller asks for the CPU, its weights drawn from
    `torch.Generator().manual_seed(seed)`. The model's dropout stream
    restarts from `seed + 1`. Batch capacities are pinned by
    `discover_caps` (its own `default_rng(seed)`) over 3 probe batches;
    the crops of the training batches draw from another
    `default_rng(seed)`. Training cycles through a pool of `pool`
    batches prepared once and kept on the device, and the losses are
    read back once, at the end."""
    from ..data.padded import from_numpy
    from ..metrics.oracle import semantic_segmentation_oracle
    from ..nn.mlp import init_weights
    from ..transforms.prepare import BatchConfig, discover_caps, prepare_batch

    rng = np.random.default_rng(seed)
    if cfg is None:
        cfg = BatchConfig()
    if task is None:
        task = _default_task(steps, crops, num_classes, device=device)
        init_weights(task.model, torch.Generator().manual_seed(seed))
    dev = next(task.model.parameters()).device
    compute_dtype = task.model.net.compute_dtype

    # capacities pinned over a few probe batches, so that every step has
    # one padded signature (discover_caps doubles them for headroom)
    probe = [[train_nag] * crops for _ in range(3)]
    cfg_train = discover_caps(probe, cfg, train=True,
                              rng=np.random.default_rng(seed))
    cfg_eval = dataclasses.replace(
        cfg, sample_graph_r=-1, sample_segment_ratio=0,
        rgb_autocontrast=0, rgb_drop=0)

    pool_n = max(1, min(pool, steps or 1))
    batches = [from_numpy(prepare_batch([train_nag] * crops, cfg_train,
                                        train=True, rng=rng),
                          dev, compute_dtype, train=True)
               for _ in range(pool_n)]
    rng_dropout = getattr(task.model.net, 'dropout_rng', None)
    if rng_dropout is not None:
        rng_dropout.manual_seed(seed + 1)

    t0 = time.time()
    loss_first = loss_last = None
    for s in range(steps):
        loss_last = task.train_step(batches[s % pool_n])['loss']
        if s == 0:
            loss_first = loss_last
        if eval_every and (s + 1) % eval_every == 0:
            em = _eval(task, eval_nag, cfg_eval, num_classes)
            log(f'[step {s + 1}] heldout miou={em["miou"]:.2f} '
                f'oa={em["oa"]:.2f} ({time.time() - t0:.0f}s)')
    if steps:
        loss_first, loss_last = torch.stack(
            [loss_first, loss_last]).float().cpu().tolist()

    em = _eval(task, eval_nag, cfg_eval, num_classes)
    y1 = np.asarray(eval_nag[1].y)[:, :num_classes]
    oracle = semantic_segmentation_oracle(y1.astype(np.int64), num_classes)
    return {
        'miou': em['miou'], 'oa': em['oa'], 'macc': em['macc'],
        'oracle_miou': float(oracle['miou']),
        'oracle_oa': float(oracle['oa']),
        'loss_first': loss_first, 'loss_last': loss_last,
        'steps': steps, 'crops': crops,
        'train_nodes_l1': int(train_nag[1].num_nodes),
        'eval_nodes_l1': int(eval_nag[1].num_nodes),
        'wall_sec': time.time() - t0,
    }


def _eval(task, eval_nag, cfg_eval, num_classes):
    """Metrics of one evaluation forward over the whole `eval_nag`."""
    from ..data.padded import from_numpy
    from ..metrics.semantic import ConfusionMatrix
    from ..transforms.prepare import prepare_batch
    dev = next(task.model.parameters()).device
    batch = from_numpy(prepare_batch([eval_nag], cfg_eval, train=False),
                       dev, task.model.net.compute_dtype, train=True)
    out = task.eval_step(batch)
    cm = ConfusionMatrix(num_classes)
    cm.merge(out['confmat'].cpu().numpy())
    return cm.all_metrics()


def _default_task(steps, crops, num_classes, device='cuda'):
    """The flagship semantic task as the CLI builds it (configs/train.yaml
    + experiment=semantic/s3dis), on `device`."""
    from ..config.loader import load_config
    from ..experiment import build_task
    from ..train import CONFIG_DIR
    cfg = load_config(CONFIG_DIR, 'train', ['experiment=semantic/s3dis'])
    return build_task(cfg, total_steps=steps, num_graphs=crops,
                      device=device)

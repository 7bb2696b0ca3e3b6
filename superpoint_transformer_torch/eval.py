"""Evaluation entry point of the port:

    python -m superpoint_transformer_torch.eval experiment=semantic/s3dis \
        ckpt_path=<dir> [tta_runs=N] [submission=True] [device=cpu]

S3DIS 6-fold protocol (the per-fold confusion matrices are summed; the
checkpoint path may hold a `{fold}` placeholder):

    python -m superpoint_transformer_torch.eval experiment=semantic/s3dis \
        s3dis_6fold=True ckpt_path='outputs/fold{fold}/checkpoints/best'

`main(argv)` composes `configs/` as the JAX `eval.py` does;
`evaluate(cfg, datasets=None)` does the work. The run is on the card
unless `device=cpu`; without a card it raises.
"""
import os.path as osp
import sys

import numpy as np

from .train import CONFIG_DIR, _device

__all__ = ['main', 'evaluate', 'evaluate_s3dis_6fold']


def evaluate(cfg, datasets=None, pq=None, ap=None):
    """One evaluation of the test split of `cfg` from its `ckpt_path`:
    the test epoch with `tta_runs` augmented passes, the per-class IoU
    table, the panoptic test epoch where the task is panoptic, and the
    held-out `submission` files. `datasets` ({'test'}) replaces
    `build_datasets(cfg)`; `pq` / `ap` are accumulators shared across
    folds. Returns the metrics; 'confmat' carries the raw counts."""
    from .data.nag import NAG
    from .datasets import DataLoader
    from .datasets.base import make_submission
    from .experiment import build_batch_config, build_datasets, build_task
    from .inference import level1_node_id, to_nag_order
    from .models.output import SemanticSegmentationOutput
    from .trainer import Trainer, _numpy
    from .transforms.prepare import discover_caps, prepare_batch

    device = _device(cfg, 'evaluate')
    dm = cfg['datamodule']
    if datasets is None:
        datasets = build_datasets(cfg, stages=('test',))
    ds = datasets['test']
    ds.process()
    batch_cfg = build_batch_config(cfg)
    loader = DataLoader(ds, batch_size=1)
    task = build_task(cfg, num_graphs=max(int(
        dm['dataloader']['batch_size']), 1), device=device)
    # capacities from the whole test split (whole tiles)
    batch_cfg = discover_caps(list(loader), batch_cfg, train=False,
                              headroom_levels=0)
    output_dir = str(cfg.get('output_dir', 'outputs'))
    trainer = Trainer(task=task, batch_cfg=batch_cfg, output_dir=output_dir)
    ckpt = cfg.get('ckpt_path')
    if ckpt and ckpt != '???':
        trainer.load_checkpoint(str(ckpt))
    metrics = trainer.validate(loader, split='test',
                               tta_runs=int(cfg.get('tta_runs', 0)))
    names = list(getattr(ds, 'class_names', []))
    present = np.asarray(metrics['present'])
    for i, v in enumerate(np.asarray(metrics['iou_per_class'])):
        name = names[i] if i < len(names) else f'class_{i}'
        print(f'  {name:<14s} IoU {float(v):6.2f}'
              f'{"" if present[i] else "  (absent)"}')
    if str(cfg['model'].get('task', 'semantic')) == 'panoptic':
        trainer.stuff_classes = tuple(dm.get('stuff_classes', ()))
        trainer.panoptic_grid_search = bool(
            cfg.get('panoptic_grid_search', True))
        metrics = {**metrics, **trainer.validate_panoptic(
            loader, split='test', pq=pq, ap=ap)}
    if bool(cfg.get('submission', False)):
        # full-resolution predictions of each cloud, in the dataset's
        # format; batch rows go back to the stored NAG's node order
        sub_dir = osp.join(output_dir, 'submission')
        for i, cid in enumerate(ds.cloud_ids):
            batch = trainer._to_device(prepare_batch([ds[i]], batch_cfg,
                                                     train=False))
            out = task.eval_step(batch)
            n1 = int(batch[1].num_nodes)
            logits = to_nag_order(_numpy(out['logits_level1'])[:n1],
                                  level1_node_id(batch, n1))
            o = SemanticSegmentationOutput(logits)
            d0 = NAG.load(ds.processed_path(cid), high=0,
                          keys_low=['sub', 'super_index'])[0]
            if d0.get('sub') is not None:
                pred = o.full_res_semantic_pred(d0.super_index, d0.sub)
            else:
                pred = o.voxel_semantic_pred(d0.super_index)
            make_submission(ds, cid, pred, sub_dir)
        print(f'submission written to {sub_dir}')
    return metrics


def evaluate_s3dis_6fold(cfg_dir, argv):
    """Evaluate each fold's checkpoint on its held-out area and sum the
    confusion matrices (and, panoptic, the instance matches). `ckpt_path`
    may hold a `{fold}` placeholder."""
    from .config import load_config
    from .metrics.mean_average_precision import MeanAveragePrecision3D
    from .metrics.panoptic import PanopticQuality3D
    from .metrics.semantic import (macc_from_confmat, miou_from_confmat,
                                   oa_from_confmat)

    base = load_config(cfg_dir, 'eval', argv)
    ckpt_template = str(base.get('ckpt_path', ''))
    pq = ap = None
    if str(base.model.get('task', 'semantic')) == 'panoptic':
        n_cls = int(base.datamodule.num_classes)
        stuff = tuple(base.datamodule.get('stuff_classes', ()))
        pq = PanopticQuality3D(n_cls, stuff_classes=stuff)
        ap = MeanAveragePrecision3D(n_cls, stuff_classes=stuff)
    total = None
    for fold in range(1, 7):
        overrides = list(argv) + [f'datamodule.fold={fold}']
        if '{fold}' in ckpt_template:
            overrides.append('ckpt_path=' + ckpt_template.format(fold=fold))
        print(f'=== fold {fold} (test area Area_{fold}) ===')
        m = evaluate(load_config(cfg_dir, 'eval', overrides), pq=pq, ap=ap)
        total = m['confmat'] if total is None else total + m['confmat']
    out = {'miou': miou_from_confmat(total), 'oa': oa_from_confmat(total),
           'macc': macc_from_confmat(total), 'confmat': total}
    if pq is not None:
        out.update(pq.compute())
        out.update({f'map_{k}' if not k.startswith('map') else k: v
                    for k, v in ap.compute().items()
                    if k in ('map', 'map_50', 'map_25', 'mar')})
    print(f"6-fold: miou={out['miou']:.2f} oa={out['oa']:.2f} "
          f"macc={out['macc']:.2f}"
          + (f" pq={out['pq']:.2f}" if 'pq' in out else ''))
    return out


def main(argv=None):
    from .config import load_config
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = load_config(CONFIG_DIR, 'eval', argv)
    if bool(cfg.get('s3dis_6fold', False)):
        return evaluate_s3dis_6fold(CONFIG_DIR, argv)
    return evaluate(cfg)


if __name__ == '__main__':
    main()

"""Inference: from a raw cloud or a preprocessed NAG to predictions.
Counterparts of `tile_cloud`, `infer_nag`, `e2e_inference`,
`level1_node_id` and `to_nag_order` in
`superpoint_transformer_tpu/inference.py`, plus `infer_batch` for a batch
that is already padded. The batch goes to the device of the model's
parameters, and the forward runs there.
"""
import dataclasses
import time

import numpy as np
import torch

from .data.nag import NAG
from .data.pad import pad_nag
from .data.padded import from_numpy
from .transforms.prepare import BatchConfig, batch_signature, process_batch
from .transforms.preprocess import preprocess_cloud

__all__ = ['EVAL_BATCH_OVERRIDES', 'tile_cloud', 'level1_node_id',
           'to_nag_order', 'infer_batch', 'infer_nag', 'e2e_inference',
           'without_level0']

# whole-tile evaluation: no cropping/subsampling, no augmentation
EVAL_BATCH_OVERRIDES = dict(sample_graph_r=-1, sample_segment_ratio=0,
                            rgb_autocontrast=0, rgb_drop=0)


def tile_cloud(data, tiling):
    """Split a raw cloud into (tx, ty) xy tiles (reference
    SampleXYTiling, src/transforms/sampling.py:471). Returns a list of
    (Data tile, raw-row indices) pairs, empty tiles left out."""
    pos = np.asarray(data.pos)[:, :2].astype(np.float64)
    tx, ty = ((int(tiling), int(tiling)) if np.isscalar(tiling)
              else (int(tiling[0]), int(tiling[1])))
    lo, hi = pos.min(0), pos.max(0)
    span = np.maximum(hi - lo, 1e-9)
    ix = np.clip(((pos[:, 0] - lo[0]) / span[0] * tx).astype(int),
                 0, tx - 1)
    iy = np.clip(((pos[:, 1] - lo[1]) / span[1] * ty).astype(int),
                 0, ty - 1)
    tid = ix * ty + iy
    order = np.argsort(tid, kind='stable')
    bounds = np.searchsorted(tid[order], np.arange(tx * ty + 1))
    tiles = []
    for k in range(tx * ty):
        idx = order[bounds[k]:bounds[k + 1]]
        if idx.shape[0] == 0:
            continue
        tile, _ = data.select(idx)
        tiles.append((tile, idx))
    return tiles


def level1_node_id(batch, n1):
    """Pre-sort NAG row of each batch-order level-1 node (the host
    path sorts levels by parent): the host copy that `from_numpy` keeps,
    or level 1's `node_id` in a batch with numpy leaves. Identity when
    the batch carries no node ids."""
    if batch.level1_node_id is not None:
        return batch.level1_node_id[:n1]
    nid = batch[1].node_id
    if isinstance(nid, np.ndarray):
        return nid[:n1].astype(np.int64)
    return np.arange(n1)


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


def _model_device(model):
    return next(model.parameters()).device, model.net.compute_dtype


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _add(timings, key, t0):
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def without_level0(nag):
    """`nag` as a nano model reads it: its levels from 1 up
    (start_i_level 1), as nano datasets load their clouds (low=1)."""
    return NAG([nag[i] for i in nag.levels[1:]], start_i_level=1)


def _pad_eval(big, cfg):
    """Pad a transform-complete NAG for an inference forward (no
    transpose neighbor tables: only a training backward reads them)."""
    return pad_nag(big, num_classes=cfg.num_classes,
                   node_caps=cfg.node_caps, k_caps=cfg.k_caps,
                   k_in_caps=cfg.k_in_caps, bucket_mode=cfg.bucket_mode,
                   with_transpose=False)


def _forward_level1(model, host, device, compute_dtype, timings=None):
    """Move a host batch to `device` and run the forward: (level-1
    logits of the valid rows in batch order, the batch's level-1 node
    ids). Accumulates 'transfer' (after a device synchronize) and
    'forward' seconds in `timings`."""
    t0 = time.perf_counter()
    batch = from_numpy(host, device, compute_dtype)
    _sync(device)
    _add(timings, 'transfer', t0)
    t0 = time.perf_counter()
    n1 = batch[1].num_nodes
    with torch.inference_mode():
        logits = model(batch)[0][:n1]
    _sync(device)
    _add(timings, 'forward', t0)
    return logits, level1_node_id(batch, n1)


def infer_nag(model, nag, cfg, fetch='argmax', timings=None):
    """Whole-tile forward on a preprocessed NAG: the level-1 prediction
    as host numpy, aligned with `nag[1]` rows. A nano model takes a NAG
    without level 0 and a `cfg` with `nano` set. `fetch='argmax'` returns
    [N1] int64 classes, `fetch='logits'` the [N1, C] f32 logits. `cfg` (a
    `BatchConfig`) may pin node_caps/k_caps so that repeated tiles share
    one padded shape. The batch goes to the device of the model's
    parameters. When `timings` (a dict) is given, the host batch build
    and padding accumulate under 'pad', the host-to-device copy under
    'transfer' and the forward under 'forward' (seconds)."""
    if fetch not in ('argmax', 'logits'):
        raise ValueError(f"infer_nag: fetch={fetch!r} ('argmax' or "
                         "'logits')")
    device, compute_dtype = _model_device(model)
    t0 = time.perf_counter()
    host = _pad_eval(process_batch([nag], cfg, train=False), cfg)
    _add(timings, 'pad', t0)
    logits, nid = _forward_level1(model, host, device, compute_dtype,
                                  timings)
    out = logits.argmax(1) if fetch == 'argmax' else logits.float()
    return to_nag_order(out.cpu().numpy(), nid)


def e2e_inference(model, data, pre_cfg=None, batch_cfg=None, tiling=None,
                  target_tile_points=1_500_000, warmup=True,
                  verbose=False):
    """Raw cloud -> full-resolution semantic predictions, end to end,
    on the device of the model's parameters.

    A nano `batch_cfg` (`nano` set) batches each tile's NAG without
    level 0 (`without_level0`); level 0 still maps the predictions back
    to the raw points.

    Phases (all timed; `info['timings_sec']` reports each, in seconds):
      tile        xy split of the raw cloud
      preprocess  per-tile `preprocess_cloud` (voxelize .. graph)
      transform   per-tile `process_batch` (features, graph)
      pin         one shared padded signature across tiles
      pad         per tile: pad to the shared signature
      transfer    per tile: host to device, ended by a synchronize
      forward     per tile: the forward, ended by a synchronize
      fetch       per tile: level-1 argmax to the host
      recover     level-1 pred -> voxel -> raw points
    The tiles run as a loop of forwards over the pinned signature. With
    `warmup`, one forward of the first tile runs first, outside the
    clock ('warmup_compile': kernel build and load, allocator warm-up).

    Returns (full_res_pred [n_raw] int32, info dict)."""
    device, compute_dtype = _model_device(model)
    pre_cfg = dict(pre_cfg or {})
    batch_cfg = batch_cfg or BatchConfig()
    n_raw = int(data.num_nodes)
    if tiling is None:
        side = max(1, int(round(np.sqrt(n_raw / target_tile_points))))
        tiling = (side, side)

    info = {'n_raw_points': n_raw, 'tiling': tuple(tiling)}
    t = {}

    t0 = time.perf_counter()
    tiles = tile_cloud(data, tiling)
    t['tile'] = time.perf_counter() - t0
    info['n_tiles'] = len(tiles)

    t0 = time.perf_counter()
    nags = [preprocess_cloud(tile, **pre_cfg) for tile, _ in tiles]
    t['preprocess'] = time.perf_counter() - t0
    info['n_voxels'] = int(sum(n[0].num_nodes for n in nags))

    t0 = time.perf_counter()
    cfg = dataclasses.replace(batch_cfg, **EVAL_BATCH_OVERRIDES)
    bigs = [process_batch([without_level0(nag) if cfg.nano else nag], cfg,
                          train=False) for nag in nags]
    t['transform'] = time.perf_counter() - t0

    # one shared padded signature across all tiles
    t0 = time.perf_counter()
    node_caps, k_caps, k_in_caps = {}, {}, {}
    for big in bigs:
        nc, kc, kic = batch_signature(big, cfg)
        for li, v in nc.items():
            node_caps[li] = max(node_caps.get(li, 0), v)
        for li, v in kc.items():
            k_caps[li] = max(k_caps.get(li, 0), v)
        for li, v in kic.items():
            k_in_caps[li] = max(k_in_caps.get(li, 0), v)
    cfg = dataclasses.replace(cfg, node_caps=node_caps,
                              k_caps=k_caps or None,
                              k_in_caps=k_in_caps or None)
    t['pin'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hosts = [_pad_eval(big, cfg) for big in bigs]
    t['pad'] = time.perf_counter() - t0
    if warmup:
        t0 = time.perf_counter()
        _forward_level1(model, hosts[0], device, compute_dtype)
        t['warmup_compile'] = time.perf_counter() - t0

    preds1 = []
    for host in hosts:
        logits, nid = _forward_level1(model, host, device, compute_dtype,
                                      t)
        t0 = time.perf_counter()
        pred = logits.argmax(1).to(torch.int32).cpu().numpy()
        t['fetch'] = t.get('fetch', 0.0) + time.perf_counter() - t0
        preds1.append(to_nag_order(pred, nid))

    t0 = time.perf_counter()
    out = np.empty(n_raw, dtype=np.int32)
    for (tile, raw_idx), nag, p1 in zip(tiles, nags, preds1):
        # level-1 pred -> voxels -> the tile's raw points (reference
        # output_semantic.py:139 full_res_semantic_pred) -> raw rows
        voxel_pred = p1[np.asarray(nag[0].super_index)]
        sub = nag[0].sub
        full = np.empty(sub.num_items, dtype=np.int32)
        full[np.asarray(sub.points)] = np.repeat(
            voxel_pred, np.asarray(sub.sizes))
        out[raw_idx] = full
    t['recover'] = time.perf_counter() - t0

    timed = sum(v for k, v in t.items() if k != 'warmup_compile')
    info['timings_sec'] = {k: round(v, 3) for k, v in t.items()}
    info['e2e_sec'] = round(timed, 3)
    info['raw_points_per_sec'] = round(n_raw / timed, 1)
    info['raw_points_per_sec_ex_transfer'] = round(
        n_raw / max(timed - t['transfer'], 1e-9), 1)
    if verbose:
        print(info, flush=True)
    return out, info

"""Inference: from a raw cloud or a preprocessed NAG to predictions.
Counterparts of `tile_cloud`, `infer_nag`, `strip_for_inference`,
`stack_batches`, `infer_nags_stacked`, `e2e_inference`, `level1_node_id`
and `to_nag_order` in `superpoint_transformer_tpu/inference.py`, plus
`infer_batch` for a batch that is already padded, its panoptic
counterpart `infer_panoptic_batch`, and `pin_signature`
(`e2e_inference`'s shared padded signature of its tiles). The batch goes to the
device of the model's parameters, and the forward runs there.
"""
import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .data.nag import NAG
from .data.pad import pad_nag
from .data.padded import PaddedNAG, from_numpy, strip_for_inference
from .models.panoptic import instance_classes, instance_partition
from .transforms.prepare import BatchConfig, batch_signature, process_batch
from .transforms.preprocess import preprocess_cloud
from .utils.profiling import annotate

__all__ = ['EVAL_BATCH_OVERRIDES', 'tile_cloud', 'level1_node_id',
           'to_nag_order', 'infer_batch', 'PanopticAnswer',
           'infer_panoptic_batch', 'infer_nag', 'e2e_inference',
           'without_level0', 'strip_for_inference', 'pin_signature',
           'stack_batches', 'infer_nags_stacked']

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
    the NAG's level-1 row order. One device-to-host copy. The argmax,
    the copy and the reordering run in one `spt.fetch` span."""
    with torch.inference_mode():
        logits = model(batch)
        with annotate('spt.fetch'):
            n1 = batch[1].num_nodes
            pred = logits[0][:n1].argmax(1).cpu().numpy()
            return to_nag_order(pred, level1_node_id(batch, n1))


class PanopticAnswer(NamedTuple):
    """The panoptic answer of a batch: the instance id [N1] and the class
    of its instance [N1] of every level-1 node in the NAG's row order,
    int64; the edge-affinity logits [E] f32 of the valid edges of the
    level-1 instance graph, in the host batch's edge order; and the
    level-1 logits [N1, C] f32 in the NAG's row order: the partition's
    inputs besides the batch's own."""
    instance: np.ndarray
    cls: np.ndarray
    edge_affinity: np.ndarray
    logits: np.ndarray


def infer_panoptic_batch(task, batch, host, settings):
    """The panoptic answer (`PanopticAnswer`) of a `PanopticTask`'s
    model on a padded batch with its level-1 instance graph
    (`from_numpy` of `host`, the host batch it came from). The forward
    (backbone, heads and edge-affinity head) runs on the batch's device;
    the level-1 logits and every padded edge's affinity logit come back
    in one device-to-host copy (span `spt.fetch`). On the host, in one
    `spt.partition` span: level 1's positions, sizes, graphs and
    instance graph are read from `host`,
    `models/panoptic.py:instance_partition` clusters the nodes with
    `settings` (`experiment.partition_settings`) and merges the
    instances of each of the task's stuff classes within a graph, and
    `instance_classes` classes each instance by its summed logits."""
    with torch.inference_mode():
        logits, ea = task.model(batch)
        with annotate('spt.fetch'):
            n1 = batch[1].num_nodes
            nc = logits[0].shape[1]
            parts = [logits[0][:n1].reshape(-1)]
            if ea is not None:
                parts.append(ea.to(logits[0].dtype))
            flat = torch.cat(parts).cpu().numpy()
            node_logits = flat[:n1 * nc].reshape(n1, nc)
            nid = level1_node_id(batch, n1)
    with annotate('spt.partition'):
        lvl = host.levels[1 - int(host.start_i_level)]
        if lvl.obj_edge_index is None:
            edges = np.zeros((2, 0), np.int64)
            edge_logits = np.zeros(0, np.float32)
        else:
            emask = np.asarray(lvl.obj_edge_mask, dtype=bool)
            edges = np.asarray(lvl.obj_edge_index)[:, emask]
            edge_logits = flat[n1 * nc:][emask]
        obj = instance_partition(
            np.asarray(lvl.pos)[:n1], node_logits, edges, edge_logits,
            node_size=None if lvl.node_size is None
            else np.asarray(lvl.node_size)[:n1],
            stuff_classes=task.stuff_classes, num_classes=nc,
            batch=np.asarray(lvl.batch)[:n1], **settings)
        cls, _ = instance_classes(obj, node_logits)
        return PanopticAnswer(to_nag_order(obj, nid),
                              to_nag_order(cls[obj], nid), edge_logits,
                              to_nag_order(node_logits, nid))


def _model_device(model):
    return next(model.parameters()).device, model.net.compute_dtype


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _phase(timings, key, device=None):
    """Phase `key` of a timed path, in one `spt.<key>` span. When
    `timings` is a dict, the phase ends with a synchronize of `device`
    (where given) and its seconds accumulate under `key`; otherwise
    nothing waits for the device."""
    t0 = time.perf_counter()
    with annotate('spt.' + key):
        yield
        if timings is not None and device is not None:
            _sync(device)
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
    ids). When `timings` is a dict, accumulates 'transfer' and 'forward'
    seconds in it, each phase ended by a device synchronize."""
    with _phase(timings, 'transfer', device):
        batch = from_numpy(host, device, compute_dtype)
    n1 = batch[1].num_nodes
    with _phase(timings, 'forward', device), torch.inference_mode():
        logits = model(batch)[0][:n1]
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
    with _phase(timings, 'pad'):
        host = _pad_eval(process_batch([nag], cfg, train=False), cfg)
    logits, nid = _forward_level1(model, host, device, compute_dtype,
                                  timings)
    out = logits.argmax(1) if fetch == 'argmax' else logits.float()
    return to_nag_order(out.cpu().numpy(), nid)


def pin_signature(bigs, cfg):
    """`cfg` with node_caps / k_caps / k_in_caps pinned to one padded
    signature shared by the transform-complete NAGs `bigs` (from
    `process_batch`): the largest of their signatures
    (`batch_signature`) level by level, so that every tile pads to one
    shape."""
    node_caps, k_caps, k_in_caps = {}, {}, {}
    for big in bigs:
        for pinned, sig in zip((node_caps, k_caps, k_in_caps),
                               batch_signature(big, cfg)):
            for li, v in sig.items():
                pinned[li] = max(pinned.get(li, 0), v)
    return dataclasses.replace(cfg, node_caps=node_caps,
                               k_caps=k_caps or None,
                               k_in_caps=k_in_caps or None)


def stack_batches(batches):
    """Stack same-signature host batches (numpy leaves, e.g. from
    `strip_for_inference`) along a new leading tile axis, leaf by leaf
    with `np.stack`: a `PaddedNAG` whose levels hold [T, ...] arrays and
    a tuple of the T tiles' node counts. Raises ValueError when the
    tiles' fields or shapes differ (pin node_caps / k_caps first)."""
    first = batches[0]
    levels = []
    for li, lvl in enumerate(first.levels):
        kw = {}
        for f in dataclasses.fields(lvl):
            vals = [getattr(b.levels[li], f.name) for b in batches]
            if f.name == 'num_nodes':
                kw[f.name] = tuple(int(v) for v in vals)
            elif any((v is None) != (vals[0] is None) for v in vals):
                raise ValueError(f'stack_batches: level {li} {f.name} is '
                                 'set in some tiles only')
            elif vals[0] is not None:
                shapes = {np.shape(v) for v in vals}
                if len(shapes) > 1:
                    raise ValueError(f'stack_batches: level {li} {f.name} '
                                     f'shapes differ: {sorted(shapes)}')
                kw[f.name] = np.stack([np.asarray(v) for v in vals])
        levels.append(dataclasses.replace(lvl, **kw))
    return PaddedNAG(levels=tuple(levels), start_i_level=first.start_i_level,
                     num_graphs=first.num_graphs)


def _tile(stacked, i):
    """Tile `i` of a stacked device batch: each leaf's `t[i]` (a
    contiguous view of a contiguous [T, ...] tensor) and the tile's node
    counts."""
    levels = tuple(dataclasses.replace(lvl, **{
        f.name: (lvl.num_nodes[i] if f.name == 'num_nodes'
                 else getattr(lvl, f.name)[i])
        for f in dataclasses.fields(lvl)
        if f.name == 'num_nodes' or getattr(lvl, f.name) is not None})
        for lvl in stacked.levels)
    return PaddedNAG(levels=levels, start_i_level=stacked.start_i_level,
                     num_graphs=stacked.num_graphs)


def _forward_stack(model, stacked, preds):
    """Forward each tile of a stacked device batch and write its level-1
    argmax into `preds[i]` ([T, cap1] int32 on the device): no host
    synchronize between the tiles."""
    with torch.inference_mode():
        for i in range(preds.shape[0]):
            preds[i] = model(_tile(stacked, i))[0].argmax(1)


def infer_nags_stacked(model, nags, cfg, timings=None, warmup=False,
                       processed=None, max_tiles_per_program=8):
    """Whole-cloud forward over preprocessed tiles, a chunk of tiles at
    a time: pad each tile to the shared signature on the host, stack,
    one host-to-device copy of the stacked batch (`from_numpy`), the
    forwards over the tile axis with no host synchronize between them,
    each tile's level-1 argmax into one device [chunk, cap1] int32
    tensor, then one synchronize and one device-to-host copy.

    `cfg` (a `BatchConfig`) should pin node_caps / k_caps / k_in_caps so
    that every tile pads to one signature (`e2e_inference` does).
    `processed` optionally carries the tiles' transform-complete NAGs
    (from `process_batch`), which are then only padded here. A nano
    model takes NAGs without level 0 and a `cfg` with `nano` set.

    Clouds of more than `max_tiles_per_program` tiles run in chunks of
    that many tiles; the last chunk repeats its final tile to fill, so
    that every chunk has one shape. With `warmup`, the first chunk runs
    once outside the clock first ('warmup_compile': kernel load,
    allocator warm-up); its predictions are not used.

    Returns a list of per-tile [N1] int32 host predictions, each in its
    NAG's level-1 row order. When `timings` is a dict, accumulates 'pad',
    'transfer', 'forward', 'fetch' (and 'warmup_compile') seconds; the
    transfer and the forwards each end with a synchronize of the model's
    device. Each phase runs in an `spt.<phase>` span."""
    device, compute_dtype = _model_device(model)
    with _phase(timings, 'pad'):
        batches, nids, n1s = [], [], []
        for ti, nag in enumerate(nags):
            big = processed[ti] if processed is not None \
                else process_batch([nag], cfg, train=False)
            b = _pad_eval(big, cfg)
            n1 = int(nag[1].num_nodes)
            # batch-row -> NAG-row map, read BEFORE strip (strip drops it)
            nids.append(level1_node_id(b, n1))
            n1s.append(n1)
            batches.append(strip_for_inference(b))
        T = len(batches)
        chunk = max(1, min(max_tiles_per_program, T))
        groups = []
        for c0 in range(0, T, chunk):
            g = batches[c0:c0 + chunk]
            g = g + [g[-1]] * (chunk - len(g))  # fill: one signature
            groups.append(stack_batches(g))
        del batches

    out_chunks = []
    for gi, host in enumerate(groups):
        with _phase(timings, 'transfer', device):
            stacked = from_numpy(host, device, compute_dtype)
        cap1 = stacked[1].pos.shape[1]
        preds = torch.empty((chunk, cap1), dtype=torch.int32,
                            device=device)
        if warmup and gi == 0:
            with _phase(timings, 'warmup_compile', device):
                _forward_stack(model, stacked, preds)
        with _phase(timings, 'forward', device):
            _forward_stack(model, stacked, preds)
        with _phase(timings, 'fetch'):
            out_chunks.append(preds.cpu().numpy())
        del stacked

    fetched = np.concatenate(out_chunks)[:T]  # [T, cap1] int32
    return [to_nag_order(fetched[i, :n1s[i]], nids[i]) for i in range(T)]


def e2e_inference(model, data, pre_cfg=None, batch_cfg=None, tiling=None,
                  target_tile_points=1_500_000, warmup=True,
                  verbose=False):
    """Raw cloud -> full-resolution semantic predictions, end to end,
    on the device of the model's parameters.

    A nano `batch_cfg` (`nano` set) batches each tile's NAG without
    level 0 (`without_level0`); level 0 still maps the predictions back
    to the raw points.

    Phases (all timed, each in an `spt.<phase>` profiler span;
    `info['timings_sec']` reports each, in seconds):
      tile        xy split of the raw cloud
      preprocess  per-tile `preprocess_cloud` (voxelize .. graph)
      transform   per-tile `process_batch` (features, graph)
      pin         one shared padded signature across tiles
      pad         per tile: pad to the shared signature, then stack
      transfer    per chunk of tiles: one host-to-device copy, ended by
                  a synchronize
      forward     per chunk: the forwards, ended by a synchronize
      fetch       per chunk: the level-1 argmax to the host
      recover     level-1 pred -> voxel -> raw points
    The tiles run through `infer_nags_stacked` over the pinned signature.
    With `warmup`, its first chunk runs once first, outside the clock
    ('warmup_compile': kernel build and load, allocator warm-up).

    Returns (full_res_pred [n_raw] int32, info dict)."""
    pre_cfg = dict(pre_cfg or {})
    batch_cfg = batch_cfg or BatchConfig()
    n_raw = int(data.num_nodes)
    if tiling is None:
        side = max(1, int(round(np.sqrt(n_raw / target_tile_points))))
        tiling = (side, side)

    info = {'n_raw_points': n_raw, 'tiling': tuple(tiling)}
    t = {}

    with _phase(t, 'tile'):
        tiles = tile_cloud(data, tiling)
    info['n_tiles'] = len(tiles)

    with _phase(t, 'preprocess'):
        nags = [preprocess_cloud(tile, **pre_cfg) for tile, _ in tiles]
    info['n_voxels'] = int(sum(n[0].num_nodes for n in nags))

    with _phase(t, 'transform'):
        cfg = dataclasses.replace(batch_cfg, **EVAL_BATCH_OVERRIDES)
        inputs = [without_level0(nag) if cfg.nano else nag for nag in nags]
        bigs = [process_batch([nag], cfg, train=False) for nag in inputs]

    with _phase(t, 'pin'):
        cfg = pin_signature(bigs, cfg)

    preds1 = infer_nags_stacked(model, inputs, cfg, timings=t,
                                warmup=warmup, processed=bigs)

    with _phase(t, 'recover'):
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

    timed = sum(v for k, v in t.items() if k != 'warmup_compile')
    info['timings_sec'] = {k: round(v, 3) for k, v in t.items()}
    info['e2e_sec'] = round(timed, 3)
    info['raw_points_per_sec'] = round(n_raw / timed, 1)
    info['raw_points_per_sec_ex_transfer'] = round(
        n_raw / max(timed - t['transfer'], 1e-9), 1)
    if verbose:
        print(info, flush=True)
    return out, info

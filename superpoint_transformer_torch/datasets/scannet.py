"""ScanNet v2: indoor scans, 20 classes of the NYU40 label set,
instances from the aggregation and segment JSON files. Raw format:
`raw/scans/<scene>/` (`raw/scans_test/<scene>/` for the test split) with
`<scene>_vh_clean_2.ply`, `<scene>_vh_clean_2.labels.ply`,
`<scene>_vh_clean_2.0.010000.segs.json` and `<scene>.aggregation.json`;
the splits from `raw/scannetv2_{train,val,test}.txt`. Counterpart of
`superpoint_transformer_tpu/datasets/scannet.py`.
"""
import glob
import json
import os.path as osp

import numpy as np

from ..data.data import Data
from ..utils.ply import read_ply
from .base import BaseDataset

__all__ = ['ScanNet', 'MiniScanNet', 'SCANNET_CLASS_NAMES',
           'SCANNET_NUM_CLASSES', 'SCANNET_TRAINID2NYU40',
           'read_scannet_scan']

SCANNET_NUM_CLASSES = 20
SCANNET_CLASS_NAMES = [
    'wall', 'floor', 'cabinet', 'bed', 'chair', 'sofa', 'table',
    'door', 'window', 'bookshelf', 'picture', 'counter', 'desk',
    'curtain', 'refrigerator', 'shower curtain', 'toilet', 'sink',
    'bathtub', 'otherfurniture', 'ignored']

# NYU40 id -> train id (valid ids used by the ScanNet benchmark)
_VALID_NYU40 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                33, 34, 36, 39]
_NYU40_TO_TRAIN = np.full(41, SCANNET_NUM_CLASSES, dtype=np.int64)
for _t, _i in enumerate(_VALID_NYU40):
    _NYU40_TO_TRAIN[_i] = _t


def read_scannet_scan(scan_dir, instances=False, label_map=None):
    """Read a scan directory: `<scan>_vh_clean_2.ply` mesh vertices +
    `<scan>_vh_clean_2.labels.ply` NYU40 labels (+ aggregation/segs
    JSONs for instances)."""
    scan = osp.basename(scan_dir.rstrip('/'))
    mesh = read_ply(osp.join(scan_dir, f'{scan}_vh_clean_2.ply'))
    v = mesh['vertex']
    data = Data(
        pos=np.stack([np.asarray(v['x']), np.asarray(v['y']),
                      np.asarray(v['z'])], 1).astype(np.float32),
        rgb=np.stack([np.asarray(v['red']), np.asarray(v['green']),
                      np.asarray(v['blue'])], 1).astype(np.uint8))
    label_path = osp.join(scan_dir, f'{scan}_vh_clean_2.labels.ply')
    if osp.exists(label_path):
        lv = read_ply(label_path)['vertex']
        nyu = np.clip(np.asarray(lv['label'], dtype=np.int64), 0, 40)
        data['y'] = _NYU40_TO_TRAIN[nyu]
    if instances:
        segs_path = osp.join(
            scan_dir, f'{scan}_vh_clean_2.0.010000.segs.json')
        agg_path = osp.join(scan_dir, f'{scan}.aggregation.json')
        if osp.exists(segs_path) and osp.exists(agg_path):
            with open(segs_path) as f:
                seg_of_vertex = np.asarray(
                    json.load(f)['segIndices'], dtype=np.int64)
            with open(agg_path) as f:
                agg = json.load(f)
            obj = np.full(data.num_nodes, -1, dtype=np.int64)
            for group in agg['segGroups']:
                mask = np.isin(seg_of_vertex, group['segments'])
                obj[mask] = group['objectId']
            data['obj'] = obj
    return data


# train id -> the first NYU40 id that maps to it (void -> 0)
SCANNET_TRAINID2NYU40 = np.asarray(
    [int(np.flatnonzero(_NYU40_TO_TRAIN == c)[0])
     for c in range(SCANNET_NUM_CLASSES)] + [0], dtype=np.int64)


class ScanNet(BaseDataset):
    class_names = SCANNET_CLASS_NAMES
    num_classes = SCANNET_NUM_CLASSES
    stuff_classes = [0, 1]
    # benchmark txt submissions carry NYU40 ids
    submission_id_map = SCANNET_TRAINID2NYU40

    def __init__(self, root, scans=None, instances=True, **kwargs):
        self._scans = scans
        self.instances = instances
        super().__init__(root, **kwargs)

    @property
    def all_cloud_ids(self):
        if self._scans is not None:
            return self._scans
        out = {'train': [], 'val': [], 'test': []}
        for split, sub in (('train', 'scans'), ('val', 'scans'),
                           ('test', 'scans_test')):
            split_file = osp.join(self.raw_dir,
                                  f'scannetv2_{split}.txt')
            if osp.exists(split_file):
                with open(split_file) as f:
                    out[split] = [l.strip() for l in f if l.strip()]
            elif split != 'val':
                out[split] = sorted(
                    osp.basename(p) for p in
                    glob.glob(osp.join(self.raw_dir, sub, 'scene*')))
        return out

    def id_to_relative_raw_path(self, cloud_id):
        sub = 'scans_test' if self._stage_of(cloud_id) == 'test' \
            else 'scans'
        return osp.join(sub, cloud_id)

    def read_single_raw_cloud(self, raw_path):
        return read_scannet_scan(raw_path, instances=self.instances)


class MiniScanNet(ScanNet):
    @property
    def all_cloud_ids(self):
        full = super().all_cloud_ids
        return {k: v[:2] for k, v in full.items()}

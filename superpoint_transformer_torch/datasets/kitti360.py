"""KITTI-360: accumulated street-scan windows, 15 classes mapped from
the KITTI-360 label ids. Raw format:
`raw/data_3d_semantics/<split>/<sequence>/static/<window>.ply` with
`x y z red green blue semantic instance`. Counterpart of
`superpoint_transformer_tpu/datasets/kitti360.py`.
"""
import glob

import numpy as np

from ..data.data import Data
from ..utils.ply import read_ply
from .base import BaseDataset

__all__ = ['KITTI360', 'MiniKITTI360', 'KITTI360_CLASS_NAMES',
           'KITTI360_NUM_CLASSES', 'KITTI360_TRAINID2ID', 'KITTI360_SEQUENCES',
           'read_kitti360_window']

KITTI360_NUM_CLASSES = 15
KITTI360_CLASS_NAMES = [
    'road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
    'traffic light', 'traffic sign', 'vegetation', 'terrain', 'person',
    'car', 'truck', 'motorcycle', 'bicycle', 'ignored']

# KITTI-360 semantic ids -> train ids (void classes -> 15); the mapping
# follows the official kitti360Scripts label definitions used by the
# reference (src/datasets/kitti360_config.py ID2TRAINID)
_ID2TRAIN = np.full(256, KITTI360_NUM_CLASSES, dtype=np.int64)
for _id, _train in {
        7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
        22: 9, 24: 10, 26: 11, 27: 12, 32: 13, 33: 14}.items():
    _ID2TRAIN[_id] = _train

# 2013_05_28_drive_{seq}_sync sequences; train/val split by windows is
# read from the data_3d_semantics train/val txt files when available
KITTI360_SEQUENCES = [
    '2013_05_28_drive_0000_sync', '2013_05_28_drive_0002_sync',
    '2013_05_28_drive_0003_sync', '2013_05_28_drive_0004_sync',
    '2013_05_28_drive_0005_sync', '2013_05_28_drive_0006_sync',
    '2013_05_28_drive_0007_sync', '2013_05_28_drive_0009_sync',
    '2013_05_28_drive_0010_sync']


def read_kitti360_window(path, instances=False):
    """The points of a KITTI-360 window: `pos` (f32), `rgb` (uint8), `y`
    (train ids, 15 for void) and, with `instances`, `obj`."""
    ply = read_ply(path)
    v = ply['vertex']
    names = v.dtype.names
    data = Data(pos=np.stack(
        [np.asarray(v['x']), np.asarray(v['y']),
         np.asarray(v['z'])], 1).astype(np.float32))
    if all(c in names for c in ('red', 'green', 'blue')):
        data['rgb'] = np.stack(
            [np.asarray(v['red']), np.asarray(v['green']),
             np.asarray(v['blue'])], 1).astype(np.uint8)
    if 'semantic' in names:
        data['y'] = _ID2TRAIN[np.clip(
            np.asarray(v['semantic'], dtype=np.int64), 0, 255)]
    if instances and 'instance' in names:
        data['obj'] = np.asarray(v['instance'], dtype=np.int64)
    return data


KITTI360_TRAINID2ID = np.asarray(
    [int(np.flatnonzero(_ID2TRAIN == c)[0])
     for c in range(KITTI360_NUM_CLASSES)] + [0], dtype=np.uint8)


class KITTI360(BaseDataset):
    class_names = KITTI360_CLASS_NAMES
    num_classes = KITTI360_NUM_CLASSES
    stuff_classes = list(range(10))
    # benchmark submission: train ids -> KITTI-360 label ids, one
    # uint8 .npy per window (reference make_submission,
    # src/datasets/kitti360.py:383-440 + TRAINID2ID)
    submission_format = 'kitti360_npy'
    submission_id_map = KITTI360_TRAINID2ID

    def __init__(self, root, windows=None, instances=False, **kwargs):
        """`windows` overrides the {'train','val','test': [...]} window
        lists (relative paths like
        '2013_05_28_drive_0000_sync/0000000002_0000000385')."""
        self._windows = windows
        self.instances = instances
        super().__init__(root, **kwargs)

    @property
    def all_cloud_ids(self):
        if self._windows is not None:
            return self._windows
        # the windows found under the raw tree
        out = {'train': [], 'val': [], 'test': []}
        for split in ('train', 'val', 'test'):
            pattern = f'{self.raw_dir}/data_3d_semantics/{split}/*/' \
                      'static/*.ply'
            for p in sorted(glob.glob(pattern)):
                parts = p.split('/')
                out[split].append(
                    f'{parts[-3]}/{parts[-1].replace(".ply", "")}')
        return out

    def id_to_relative_raw_path(self, cloud_id):
        seq, win = cloud_id.split('/')
        stage = self._stage_of(cloud_id)
        return f'data_3d_semantics/{stage}/{seq}/static/{win}.ply'

    def read_single_raw_cloud(self, raw_path):
        return read_kitti360_window(raw_path, instances=self.instances)


class MiniKITTI360(KITTI360):
    @property
    def all_cloud_ids(self):
        full = super().all_cloud_ids
        return {k: v[:1] for k, v in full.items()}

"""S3DIS: 6 building areas, the fold is the held-out test area, 13
classes. Raw format: `Area_<i>/<room>/Annotations/<class>_<k>.txt` with
`x y z r g b` rows. Counterpart of `superpoint_transformer_tpu/datasets/
s3dis.py`.
"""
import glob
import os.path as osp

import numpy as np

from ..data.data import Data
from .base import BaseDataset

__all__ = ['S3DIS', 'MiniS3DIS', 'S3DIS_CLASS_NAMES',
           'S3DIS_NUM_CLASSES', 'S3DIS_STUFF_CLASSES',
           'S3DIS_ROOM_TYPES', 'read_s3dis_room', 'read_s3dis_area']

S3DIS_CLASS_NAMES = [
    'ceiling', 'floor', 'wall', 'beam', 'column', 'window', 'door',
    'chair', 'table', 'bookcase', 'sofa', 'board', 'clutter', 'ignored']

S3DIS_NUM_CLASSES = 13
# the panoptic 'with_stuff' setting treats ceiling, floor and wall as
# stuff
S3DIS_STUFF_CLASSES = [0, 1, 2]
S3DIS_ROOM_TYPES = (
    'office', 'conferenceRoom', 'hallway', 'auditorium', 'openspace',
    'lobby', 'lounge', 'pantry', 'copyRoom', 'storage', 'WC')

_OBJECT_LABEL = {name: i for i, name in enumerate(S3DIS_CLASS_NAMES[:13])}
# 'stairs' appear in some rooms: unknown classes map to clutter
_CLUTTER = _OBJECT_LABEL['clutter']


def read_s3dis_room(room_dir, instances=False):
    """Read one room from its Annotations/*.txt object files."""
    pos_list, rgb_list, y_list, obj_list = [], [], [], []
    files = sorted(glob.glob(osp.join(room_dir, 'Annotations', '*.txt')))
    for i_obj, fp in enumerate(files):
        name = osp.basename(fp).split('_')[0]
        label = _OBJECT_LABEL.get(name, _CLUTTER)
        try:
            arr = np.loadtxt(fp, dtype=np.float32, ndmin=2)
        except ValueError:
            # some raw files hold stray characters: a tolerant parse
            rows = []
            with open(fp, 'rb') as f:
                for line in f:
                    parts = line.replace(b'\x1a', b' ').split()
                    if len(parts) >= 6:
                        rows.append([float(x) for x in parts[:6]])
            arr = np.asarray(rows, dtype=np.float32)
        if arr.size == 0:
            continue
        pos_list.append(arr[:, :3])
        rgb_list.append(arr[:, 3:6].astype(np.uint8))
        y_list.append(np.full(arr.shape[0], label, dtype=np.int64))
        obj_list.append(np.full(arr.shape[0], i_obj, dtype=np.int64))
    if not pos_list:
        raise FileNotFoundError(f'no annotation files in {room_dir}')
    data = Data(
        pos=np.concatenate(pos_list),
        rgb=np.concatenate(rgb_list),
        y=np.concatenate(y_list))
    if instances:
        data['obj'] = np.concatenate(obj_list)
    return data


def read_s3dis_area(area_dir, instances=False):
    """Concatenate all rooms of an area into one cloud, with per-room
    instance offsets."""
    rooms = sorted(
        d for d in glob.glob(osp.join(area_dir, '*'))
        if osp.isdir(d) and osp.isdir(osp.join(d, 'Annotations')))
    datas = []
    obj_offset = 0
    for r in rooms:
        d = read_s3dis_room(r, instances=instances)
        if instances:
            d['obj'] = d.obj + obj_offset
            obj_offset = int(d.obj.max()) + 1
        datas.append(d)
    return Data(
        pos=np.concatenate([d.pos for d in datas]),
        rgb=np.concatenate([d.rgb for d in datas]),
        y=np.concatenate([d.y for d in datas]),
        **({'obj': np.concatenate([d.obj for d in datas])}
           if instances else {}))


class S3DIS(BaseDataset):
    """Area-level S3DIS; `fold` is the test area."""
    class_names = S3DIS_CLASS_NAMES
    num_classes = 13
    stuff_classes = []
    val_mixed_in_train = True

    def __init__(self, root, fold=5, instances=False, **kwargs):
        self.fold = fold
        self.instances = instances
        super().__init__(root, **kwargs)

    @property
    def all_cloud_ids(self):
        areas = [f'Area_{i}' for i in range(1, 7)]
        test = [f'Area_{self.fold}']
        train = [a for a in areas if a not in test]
        return {'train': train, 'val': train, 'test': test}

    def id_to_relative_raw_path(self, cloud_id):
        return cloud_id

    def read_single_raw_cloud(self, raw_path):
        return read_s3dis_area(raw_path, instances=self.instances)


class MiniS3DIS(S3DIS):
    """One training area and the test area, for fast runs."""

    @property
    def all_cloud_ids(self):
        return {'train': ['Area_1'], 'val': ['Area_1'],
                'test': [f'Area_{self.fold}']}

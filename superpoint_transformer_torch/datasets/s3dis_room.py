"""S3DISRoom: the room-level variant of S3DIS, each room its own cloud
instead of a whole area; the fold is the held-out area, as in S3DIS.
Counterpart of `superpoint_transformer_tpu/datasets/s3dis_room.py`.
"""
import os
import os.path as osp

from .base import BaseDataset
from .s3dis import (
    S3DIS_CLASS_NAMES, S3DIS_NUM_CLASSES, S3DIS_STUFF_CLASSES,
    S3DIS_ROOM_TYPES, read_s3dis_room)

__all__ = ['S3DISRoom', 'MiniS3DISRoom']


class S3DISRoom(BaseDataset):
    class_names = S3DIS_CLASS_NAMES
    num_classes = S3DIS_NUM_CLASSES
    stuff_classes = S3DIS_STUFF_CLASSES
    val_mixed_in_train = True

    def __init__(self, root, fold=5, instances=False, **kwargs):
        self.fold = fold
        self.instances = instances
        super().__init__(root, **kwargs)

    def _rooms_of_area(self, area):
        area_dir = osp.join(self.raw_dir, area)
        if osp.isdir(area_dir):
            return sorted(
                d for d in os.listdir(area_dir)
                if osp.isdir(osp.join(area_dir, d))
                and any(d.startswith(t) for t in S3DIS_ROOM_TYPES))
        # raw data absent (a preprocessed cache only): no listing
        return []

    @property
    def all_cloud_ids(self):
        areas = [f'Area_{i}' for i in range(1, 7)]
        test_area = f'Area_{self.fold}'
        train = [f'{a}/{r}' for a in areas if a != test_area
                 for r in self._rooms_of_area(a)]
        test = [f'{test_area}/{r}'
                for r in self._rooms_of_area(test_area)]
        return {'train': train, 'val': train[:1], 'test': test}

    def id_to_relative_raw_path(self, cloud_id):
        return cloud_id

    def read_single_raw_cloud(self, raw_path):
        return read_s3dis_room(raw_path, instances=self.instances)


class MiniS3DISRoom(S3DISRoom):
    """A handful of rooms for fast end-to-end runs."""

    @property
    def all_cloud_ids(self):
        full = super().all_cloud_ids
        return {'train': full['train'][:2], 'val': full['train'][:1],
                'test': full['test'][:1]}

"""DALES: 40 aerial LiDAR tiles of 1 km², 8 classes, an intensity
channel. Raw format: `raw/<tile>.ply` with a 'testing' element holding
`x y z intensity sem_class ins_class`. Counterpart of
`superpoint_transformer_tpu/datasets/dales.py`.
"""
import numpy as np

from ..data.data import Data
from ..utils.ply import read_ply
from .base import BaseDataset

__all__ = ['DALES', 'MiniDALES', 'DALES_CLASS_NAMES', 'DALES_NUM_CLASSES',
           'DALES_ID2TRAINID', 'DALES_TILES', 'read_dales_tile']

DALES_NUM_CLASSES = 8
# raw label id -> train id (0 is 'unknown' -> void 8)
DALES_ID2TRAINID = np.asarray([8, 0, 1, 2, 3, 4, 5, 6, 7])
DALES_CLASS_NAMES = [
    'Ground', 'Vegetation', 'Cars', 'Trucks', 'Power lines', 'Fences',
    'Poles', 'Buildings', 'Unknown']

DALES_TILES = {
    'train': [
        '5080_54435_new', '5190_54400_new', '5105_54460_new',
        '5130_54355_new', '5165_54395_new', '5185_54390_new',
        '5180_54435_new', '5085_54320_new', '5100_54495_new',
        '5110_54320_new', '5140_54445_new', '5105_54405_new',
        '5185_54485_new', '5165_54390_new', '5145_54460_new',
        '5110_54460_new', '5180_54485_new', '5150_54340_new',
        '5145_54405_new', '5145_54470_new', '5160_54330_new',
        '5135_54495_new', '5145_54480_new', '5115_54480_new',
        '5110_54495_new', '5095_54440_new'],
    'val': ['5145_54340_new', '5095_54455_new', '5110_54475_new'],
    'test': [
        '5080_54470_new', '5100_54440_new', '5140_54390_new',
        '5080_54400_new', '5155_54335_new', '5150_54325_new',
        '5120_54445_new', '5135_54435_new', '5175_54395_new',
        '5100_54490_new', '5135_54430_new']}


def read_dales_tile(path, intensity=True, semantic=True, instance=False,
                    remap=True):
    """The points of a DALES tile: `pos` (f32), `intensity` in [0, 1]
    ([N, 1] f32), `y` (train ids, 8 for 'unknown') and, with `instance`,
    `obj` (the raw instance ids)."""
    ply = read_ply(path)
    key = 'testing' if 'testing' in ply else list(ply.keys())[0]
    v = ply[key]
    data = Data(pos=np.stack(
        [np.asarray(v['x']), np.asarray(v['y']),
         np.asarray(v['z'])], 1).astype(np.float32))
    if intensity and 'intensity' in v.dtype.names:
        # the reference's normalization into [0, 1] (dales.py:73)
        inten = np.asarray(v['intensity'], dtype=np.float32)
        data['intensity'] = np.sqrt(
            np.clip(inten, 0, 60000) / 60000).reshape(-1, 1)
    if semantic and 'sem_class' in v.dtype.names:
        y = np.asarray(v['sem_class'], dtype=np.int64)
        if remap:
            y = DALES_ID2TRAINID[np.clip(y, 0, 8)]
        data['y'] = y
    if instance and 'ins_class' in v.dtype.names:
        data['obj'] = np.asarray(v['ins_class'], dtype=np.int64)
    return data


class DALES(BaseDataset):
    class_names = DALES_CLASS_NAMES
    num_classes = DALES_NUM_CLASSES
    stuff_classes = [0, 1]

    def __init__(self, root, instances=False, **kwargs):
        self.instances = instances
        super().__init__(root, **kwargs)

    @property
    def all_cloud_ids(self):
        return DALES_TILES

    def read_single_raw_cloud(self, raw_path):
        return read_dales_tile(raw_path, instance=self.instances)


class MiniDALES(DALES):
    @property
    def all_cloud_ids(self):
        return {k: v[:2] for k, v in DALES_TILES.items()}

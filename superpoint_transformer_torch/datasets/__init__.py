"""Datasets (S3DIS by area and by room, DALES, KITTI-360, ScanNet),
loaders and submission files."""
from .base import (BaseDataset, DataLoader, PreparedDataLoader,  # noqa: F401
                   make_submission)
from .dales import DALES, MiniDALES, DALES_CLASS_NAMES  # noqa: F401
from .kitti360 import KITTI360, MiniKITTI360, KITTI360_CLASS_NAMES  # noqa: F401
from .s3dis import S3DIS, MiniS3DIS, S3DIS_CLASS_NAMES  # noqa: F401
from .s3dis_room import S3DISRoom, MiniS3DISRoom  # noqa: F401
from .scannet import ScanNet, MiniScanNet, SCANNET_CLASS_NAMES  # noqa: F401

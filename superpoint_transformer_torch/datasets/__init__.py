"""Datasets (S3DIS by area and by room), loaders and submission files.
The DALES, KITTI-360 and ScanNet readers are not ported."""
from .base import (BaseDataset, DataLoader, PreparedDataLoader,  # noqa: F401
                   make_submission)
from .s3dis import S3DIS, MiniS3DIS, S3DIS_CLASS_NAMES  # noqa: F401
from .s3dis_room import S3DISRoom, MiniS3DISRoom  # noqa: F401

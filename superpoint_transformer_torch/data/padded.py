"""Padded, static-shape tensor representation of a NAG batch.

Counterpart of `PaddedLevel` / `PaddedNAG` in
`superpoint_transformer_tpu/data/pad.py`, as plain dataclasses with the
same field names. The host path (`data.pad.pad_nag`,
`transforms.prepare.prepare_batch` without a device,
`utils.synthetic.random_padded_nag`) fills them with numpy arrays;
`from_numpy`, the one host-to-device boundary, converts such a batch
into an inference or training batch of tensors on a torch device.
`PaddedPointCloud` is EZ-SP's single-level batch of voxels
(`data.pad.pad_point_cloud`), moved to a device by
`point_cloud_from_numpy`.

Padding invariants (set by the host path, relied on by the model):
levels are sorted by `super_index`; padded rows have `batch == -1` and
`super_index == parent capacity`; padded neighbor slots point at node 0
with `nbr_mask` False.
"""
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ['PaddedLevel', 'PaddedNAG', 'PaddedPointCloud', 'from_numpy',
           'point_cloud_from_numpy']


@dataclass
class PaddedLevel:
    """One partition level, padded to capacity N (and K neighbor
    slots): tensors on a device, or numpy arrays on the host."""
    pos: torch.Tensor                          # [N, 3] f32
    node_mask: torch.Tensor                    # [N] bool
    batch: torch.Tensor                        # [N] int64 graph id, -1 pad
    num_nodes: int                             # valid rows (host int)
    x: Optional[torch.Tensor] = None           # [N, Dx] features
    node_size: Optional[torch.Tensor] = None   # [N] f32
    super_index: Optional[torch.Tensor] = None  # [N] int64 parent slot
    nbr_idx: Optional[torch.Tensor] = None     # [N, K] int64
    nbr_mask: Optional[torch.Tensor] = None    # [N, K] bool
    edge_feat: Optional[torch.Tensor] = None   # [N, K, De]
    y: Optional[torch.Tensor] = None           # [N, C+1] label histogram
    v_edge_attr: Optional[torch.Tensor] = None  # [N, Dv]
    obj_edge_index: Optional[torch.Tensor] = None   # [2, Eo]
    obj_edge_mask: Optional[torch.Tensor] = None    # [Eo]
    obj_edge_affinity: Optional[torch.Tensor] = None  # [Eo]
    cnn_nbr_idx: Optional[torch.Tensor] = None      # [N, K^3]
    nbr_in_idx: Optional[torch.Tensor] = None       # [N, K_in]
    nbr_in_mask: Optional[torch.Tensor] = None      # [N, K_in]
    node_id: Optional[torch.Tensor] = None          # [N] pre-sort row

    @property
    def capacity(self):
        return self.pos.shape[0]


@dataclass
class PaddedNAG:
    levels: Tuple[PaddedLevel, ...]
    start_i_level: int = 0
    num_graphs: int = 1
    # host-side copy of level 1's `node_id` (pre-sort NAG row of each
    # batch row), kept by `from_numpy` when it drops `node_id`
    level1_node_id: Optional[np.ndarray] = None

    def __getitem__(self, i):
        return self.levels[i - self.start_i_level]

    @property
    def num_levels(self):
        return len(self.levels)

    @property
    def absolute_num_levels(self):
        return self.start_i_level + len(self.levels)

    @property
    def end_i_level(self):
        return self.absolute_num_levels - 1


@dataclass
class PaddedPointCloud:
    """One padded level of voxels for EZ-SP's partition stage: features,
    the sparse-convolution rulebook and the adjacency edges of a batch of
    graphs, numpy arrays on the host or tensors on a device. Padded rows
    have `batch == -1` and `node_mask` False; padded edges are (0, 0)
    with `edge_mask` False."""
    pos: torch.Tensor                     # [N, 3] f32
    x: torch.Tensor                       # [N, D] f32
    node_mask: torch.Tensor               # [N] bool
    batch: torch.Tensor                   # [N] graph id, -1 pad
    num_nodes: int                        # valid rows (host int)
    cnn_nbr_idx: torch.Tensor             # [N, K^3], -1 empty site
    edge_index: torch.Tensor              # [2, E]
    edge_mask: torch.Tensor               # [E] bool
    y: Optional[torch.Tensor] = None      # [N, C+1] label histograms

    @property
    def capacity(self):
        return self.pos.shape[0]


# fields only a training step reads on the device: the label histograms
# and the transpose neighbor tables (the k/v gathers' backward,
# `ops/gather.py:gather_rows_t`), dropped from an inference batch as the
# JAX `strip_for_inference` does
_TRAIN_ONLY = ('y', 'nbr_in_idx', 'nbr_in_mask')
# heavy float features cast to the compute dtype
_FEATURES = ('x', 'edge_feat', 'v_edge_attr')


def _to_tensor(name, a, device, feat_dtype, pin):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    else:
        dtype = feat_dtype if name in _FEATURES else torch.float32
    if pin:
        # cast on the host, then one asynchronous copy from pinned memory
        return t.to(dtype).pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


def from_numpy(batch, device, compute_dtype=None, train=False,
               pin_memory=False):
    """Convert a batch with numpy leaves into a `PaddedNAG` of tensors
    on `device`, ready for an inference forward, or with `train` for a
    training step.

    `batch` is any object whose fields are named like the JAX
    `PaddedNAG` (`levels`, `start_i_level`, `num_graphs`) and whose
    levels are named like `PaddedLevel`. `node_id` is dropped (level 1's
    is kept on the host as `level1_node_id`); the label histograms `y`
    and the transpose neighbor tables `nbr_in_idx`, `nbr_in_mask` are
    kept when `train` and dropped otherwise, as the JAX
    `strip_for_inference` does. `x`,
    `edge_feat` and `v_edge_attr` are cast to bf16 when `compute_dtype` is
    bf16. Index tensors become int64. With `pin_memory` and a CUDA
    `device`, each leaf is copied from pinned host memory without
    blocking the host."""
    device = torch.device(device)
    pin = pin_memory and device.type == 'cuda'
    feat_dtype = torch.bfloat16 if compute_dtype in ('bf16', 'bfloat16') \
        else torch.float32
    start = int(batch.start_i_level)
    nid = None
    if start <= 1 < start + len(batch.levels):
        lvl1 = batch.levels[1 - start]
        if getattr(lvl1, 'node_id', None) is not None:
            nid = np.asarray(lvl1.node_id).astype(np.int64)
    levels = []
    for lvl in batch.levels:
        kw = {}
        for f in dataclasses.fields(PaddedLevel):
            v = getattr(lvl, f.name, None)
            if f.name == 'num_nodes':
                kw[f.name] = int(v)
            elif v is not None and f.name != 'node_id' \
                    and (train or f.name not in _TRAIN_ONLY):
                kw[f.name] = _to_tensor(f.name, v, device, feat_dtype, pin)
        levels.append(PaddedLevel(**kw))
    return PaddedNAG(levels=tuple(levels), start_i_level=start,
                     num_graphs=int(batch.num_graphs),
                     level1_node_id=nid)


def point_cloud_from_numpy(cloud, device):
    """A `PaddedPointCloud` with numpy leaves as one of tensors on
    `device`: floats in f32, index tensors in int64, masks in bool;
    `num_nodes` stays a host int."""
    device = torch.device(device)
    kw = {}
    for f in dataclasses.fields(PaddedPointCloud):
        v = getattr(cloud, f.name)
        if f.name == 'num_nodes':
            kw[f.name] = int(v)
        elif v is not None:
            kw[f.name] = _to_tensor(f.name, v, device, torch.float32, False)
    return PaddedPointCloud(**kw)

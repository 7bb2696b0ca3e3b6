"""Padded, static-shape tensor representation of a NAG batch.

Counterpart of `PaddedLevel` / `PaddedNAG` in
`superpoint_transformer_tpu/data/pad.py`, as plain dataclasses of
tensors with the same field names. `from_numpy` converts a batch with
numpy leaves (the JAX host path's `prepare_batch(..., device=False)`, or
`utils.synthetic.random_padded_nag`) into an inference or training batch
on a torch device.

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

__all__ = ['PaddedLevel', 'PaddedNAG', 'bucket', 'from_numpy']


@dataclass
class PaddedLevel:
    """One partition level, padded to capacity N (and K neighbor
    slots)."""
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


def bucket(n, minimum=128):
    """Round a count up to a static capacity: eight steps per
    power-of-two octave, in multiples of at least 128 (the host path's
    default 'pow2_fine' buckets)."""
    n = max(int(n), minimum)
    q = max(1 << max((n - 1).bit_length() - 3, 0), 128)
    return -(-n // q) * q


# fields the port never reads on the device: the transpose neighbor
# tables (the JAX backward's gather_rows_t; the port's gather backward,
# `ops/segment.py:gather_rows`, sums the same cotangents) and host-side
# row ids
_DROPPED = ('nbr_in_idx', 'nbr_in_mask', 'node_id')
# heavy float features cast to the compute dtype
_FEATURES = ('x', 'edge_feat', 'v_edge_attr')


def _to_tensor(name, a, device, feat_dtype):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype == np.bool_:
        return t.to(device)
    if np.issubdtype(a.dtype, np.integer):
        return t.to(device=device, dtype=torch.int64)
    dtype = feat_dtype if name in _FEATURES else torch.float32
    return t.to(device=device, dtype=dtype)


def from_numpy(batch, device, compute_dtype=None, train=False):
    """Convert a batch with numpy leaves into a `PaddedNAG` of tensors
    on `device`, ready for an inference forward, or with `train` for a
    training step.

    `batch` is any object whose fields are named like the JAX
    `PaddedNAG` (`levels`, `start_i_level`, `num_graphs`) and whose
    levels are named like `PaddedLevel`. `nbr_in_idx`, `nbr_in_mask` and
    `node_id` are dropped (level 1's `node_id` is kept on the host as
    `level1_node_id`); the label histograms `y` are kept when `train` and
    dropped otherwise, as the JAX `strip_for_inference` does. `x`,
    `edge_feat` and `v_edge_attr` are cast to bf16 when `compute_dtype` is
    bf16. Index tensors become int64."""
    device = torch.device(device)
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
            elif v is not None and f.name not in _DROPPED \
                    and (train or f.name != 'y'):
                kw[f.name] = _to_tensor(f.name, v, device, feat_dtype)
        levels.append(PaddedLevel(**kw))
    return PaddedNAG(levels=tuple(levels), start_i_level=start,
                     num_graphs=int(batch.num_graphs),
                     level1_node_id=nid)

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
with `nbr_mask` False. Every integer leaf holds row, neighbor-slot or
graph indices, at most the element count of the batch's largest leaf,
so `from_numpy` ships them to a card as int32.
"""
import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate

__all__ = ['PaddedLevel', 'PaddedNAG', 'PaddedPointCloud', 'from_numpy',
           'point_cloud_from_numpy', 'strip_for_inference']


@dataclass
class PaddedLevel:
    """One partition level, padded to capacity N (and K neighbor
    slots): tensors on a device, or numpy arrays on the host."""
    pos: torch.Tensor                          # [N, 3] f32
    node_mask: torch.Tensor                    # [N] bool
    batch: torch.Tensor                        # [N] int64 graph id, -1 pad
    num_nodes: int                             # valid rows (host int; a
                                               # tuple, one a tile, in a
                                               # stacked batch)
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

    def __getstate__(self):
        # a staged batch's leaves are views of one buffer in several
        # dtypes, which `torch.save` refuses: each pickles on its own
        return {k: v.clone() if isinstance(v, torch.Tensor)
                and v._base is not None else v
                for k, v in self.__dict__.items()}


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


# fields only a training step reads on the device: the label histograms,
# the transpose neighbor tables (the k/v gathers' backward,
# `ops/gather.py:gather_rows_t`) and the instance graph's target
# affinities (the edge-affinity loss); and `node_id`, host metadata (batch
# row -> NAG row) that callers read before the batch goes to the device
_TRAIN_ONLY = ('y', 'nbr_in_idx', 'nbr_in_mask', 'obj_edge_affinity')
_HOST_ONLY = ('node_id',)
# heavy float features cast to the compute dtype
_FEATURES = ('x', 'edge_feat', 'v_edge_attr')


def strip_for_inference(batch):
    """The host half of an inference batch's transfer (the JAX
    `strip_for_inference`): `batch` (named like `PaddedNAG`, any leaves)
    as a `PaddedNAG` without the fields an inference forward never reads,
    `y`, `nbr_in_idx`, `nbr_in_mask`, `obj_edge_affinity` and `node_id`,
    nor any leaf that `PaddedLevel` does not name (the instance centroid
    targets `obj_pos` of a NAG's level among them). The instance graph,
    `obj_edge_index` and `obj_edge_mask`, stays. Read level 1's node ids
    (`inference.level1_node_id`) before stripping. The cast of the
    features to the compute dtype happens in `from_numpy`."""
    drop = _TRAIN_ONLY + _HOST_ONLY
    levels = tuple(
        PaddedLevel(**{f.name: None if f.name in drop
                       else getattr(lvl, f.name, None)
                       for f in dataclasses.fields(PaddedLevel)})
        for lvl in batch.levels)
    return PaddedNAG(levels=levels, start_i_level=int(batch.start_i_level),
                     num_graphs=int(batch.num_graphs),
                     level1_node_id=getattr(batch, 'level1_node_id', None))


# every leaf of a staged batch starts at a multiple of this many bytes:
# the caching allocator's alignment, so each device view is as aligned as
# a tensor of its own
_ALIGN = 512


def _dtype(name, a, feat_dtype, index_dtype):
    """The torch dtype leaf `name` (numpy array `a`) takes: bools stay
    bool, integers take `index_dtype`, the features the compute dtype and
    other floats f32."""
    if a.dtype == np.bool_:
        return torch.bool
    if np.issubdtype(a.dtype, np.integer):
        return index_dtype
    return feat_dtype if name in _FEATURES else torch.float32


def _to_tensor(name, a, device, feat_dtype):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=_dtype(name, a, feat_dtype, torch.int64))


class _StagingRing:
    """Two reused host buffers ("slots"), pinned for a card, each with the
    event of the last copy out of it. `stage` takes the slots in turn,
    waits on a slot's event only while its previous copy still runs, and
    grows a slot to the batch in hand, rounded up to a power of two; it
    never shrinks. The lock keeps two threads off one slot."""

    def __init__(self, pin):
        self.pin = pin
        self.lock = threading.Lock()
        self.slots = [None, None]
        self.events = [None, None]
        self.next = 0

    def stage(self, plan, nbytes, device):
        """Write the leaves of `plan` (`_plan`) into the next slot and copy
        its first `nbytes` into a fresh `uint8` buffer on `device`, in one
        non-blocking copy on the current stream. Returns that buffer."""
        with self.lock:
            i = self.next
            self.next = 1 - i
            event = self.events[i]
            if event is not None and not event.query():
                from_numpy.stage_waits += 1
                event.synchronize()
            slot = self.slots[i]
            if slot is None or slot.numel() < nbytes:
                self.slots[i] = slot = None  # free the old one first
                slot = self.slots[i] = torch.empty(
                    1 << max(nbytes - 1, 0).bit_length(), dtype=torch.uint8,
                    pin_memory=self.pin)
                from_numpy.stage_grows += 1
            for _, a, dtype, off, n in plan:
                slot[off:off + n].view(dtype).view(a.shape).copy_(
                    torch.from_numpy(np.ascontiguousarray(a)))
            out = torch.empty(nbytes, dtype=torch.uint8, device=device)
            out.copy_(slot[:nbytes], non_blocking=True)
            if device.type == 'cuda':
                event = self.events[i] = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
        return out


def _plan(leaves, feat_dtype):
    """The layout of `leaves` ([(key, name, array)]) in one buffer:
    [(key, array, dtype it crosses in, byte offset, bytes)], each offset a
    multiple of `_ALIGN`, and the bytes used. Integer leaves cross as
    int32: each holds a row, neighbor-slot or graph index of the batch,
    at most the element count of its largest leaf, so the narrowing is
    exact while that count is below 2**31; a larger batch raises."""
    largest = max((a.size for _, _, a in leaves), default=0)
    if largest >= 2 ** 31:
        raise ValueError(f'a leaf of {largest} elements: indices into it '
                         'do not fit the int32 the batch crosses in')
    plan, used = [], 0
    for key, name, a in leaves:
        dtype = _dtype(name, a, feat_dtype, torch.int32)
        off = -(-used // _ALIGN) * _ALIGN
        n = a.size * dtype.itemsize
        plan.append((key, a, dtype, off, n))
        used = off + n
    return plan, used


def _unpack(buf, plan):
    """{key: leaf} as typed views of `buf`, the buffer `plan` was staged
    into; integer leaves are widened to int64 there, one cast each."""
    out = {}
    for key, a, dtype, off, n in plan:
        t = buf[off:off + n].view(dtype).view(a.shape)
        out[key] = t.long() if dtype == torch.int32 else t
    return out


# one staging ring a card, made on its first batch
_RINGS = {}
_RINGS_LOCK = threading.Lock()


def _ring(device):
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    with _RINGS_LOCK:
        if device not in _RINGS:
            _RINGS[device] = _StagingRing(pin=True)
        return _RINGS[device]


def from_numpy(batch, device, compute_dtype=None, train=False,
               pin_memory=False):
    """Convert a batch with numpy leaves into a `PaddedNAG` of tensors
    on `device`, ready for an inference forward, or with `train` for a
    training step.

    `batch` is any object whose fields are named like the JAX
    `PaddedNAG` (`levels`, `start_i_level`, `num_graphs`) and whose
    levels are named like `PaddedLevel`. `node_id` is dropped (level 1's
    is kept on the host as `level1_node_id`); the label histograms `y`,
    the transpose neighbor tables `nbr_in_idx`, `nbr_in_mask` and the
    target affinities `obj_edge_affinity` are kept when `train` and
    dropped otherwise (`strip_for_inference`); the instance graph
    `obj_edge_index`, `obj_edge_mask` crosses either way.
    `x`, `edge_feat` and `v_edge_attr` are cast to bf16 when
    `compute_dtype` is bf16, other floats to f32. Index tensors become
    int64. A stacked batch (`inference.stack_batches`: a leading tile
    axis on every leaf, a tuple of node counts a level) converts the
    same way.

    On a CUDA `device` every call stages: each leaf is written, cast to
    the dtype it crosses in (integers as int32), into one reused pinned
    host buffer (the card's `_StagingRing`), the batch crosses in one
    non-blocking copy on the current stream, and the leaves are views of
    one device buffer, the integer ones widened to int64 on the card.
    The host returns without waiting for the copy. `pin_memory` is
    accepted and selects nothing. On the CPU each leaf is converted on
    its own.

    The work runs in one `spt.batch` span. On a CUDA `device`,
    `from_numpy.calls` counts the calls and `from_numpy.bytes` the bytes
    the copies move; `from_numpy.stage_waits` counts the calls that
    waited on a slot's earlier copy and `from_numpy.stage_grows` the
    slots allocated or grown."""
    with annotate('spt.batch'):
        device = torch.device(device)
        return _from_numpy(batch, device, compute_dtype, train,
                           _ring(device) if device.type == 'cuda' else None)


# calls and bytes shipped to a CUDA device since import (plain CPU calls
# are not counted), and the staging rings' waits and growths
from_numpy.calls = 0
from_numpy.bytes = 0
from_numpy.stage_waits = 0
from_numpy.stage_grows = 0


def _from_numpy(batch, device, compute_dtype, train, ring):
    """`from_numpy` through `ring` (a `_StagingRing`), or leaf by leaf
    with none."""
    feat_dtype = torch.bfloat16 if compute_dtype in ('bf16', 'bfloat16') \
        else torch.float32
    start = int(batch.start_i_level)
    nid = None
    if start <= 1 < start + len(batch.levels):
        lvl1 = batch.levels[1 - start]
        if getattr(lvl1, 'node_id', None) is not None:
            nid = np.asarray(lvl1.node_id).astype(np.int64)
    if not train:
        batch = strip_for_inference(batch)
    leaves = [((i, f.name), f.name, np.asarray(getattr(lvl, f.name)))
              for i, lvl in enumerate(batch.levels)
              for f in dataclasses.fields(PaddedLevel)
              if f.name not in ('num_nodes',) + _HOST_ONLY
              and getattr(lvl, f.name, None) is not None]
    if ring is None:
        tensors = {key: _to_tensor(name, a, device, feat_dtype)
                   for key, name, a in leaves}
    else:
        plan, nbytes = _plan(leaves, feat_dtype)
        tensors = _unpack(ring.stage(plan, nbytes, device), plan)
        if device.type == 'cuda':
            from_numpy.calls += 1
            from_numpy.bytes += nbytes
    levels = []
    for i, lvl in enumerate(batch.levels):
        v = lvl.num_nodes
        kw = {name: t for (j, name), t in tensors.items() if j == i}
        kw['num_nodes'] = tuple(int(x) for x in v) \
            if isinstance(v, (tuple, list)) else int(v)
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
            kw[f.name] = _to_tensor(f.name, v, device, torch.float32)
    return PaddedPointCloud(**kw)

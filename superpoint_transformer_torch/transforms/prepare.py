"""Batch preparation on the host: loaded NAGs -> augmented,
feature-complete, padded batch. A copy of `BatchConfig`,
`process_batch`, `prepare_batch`, `batch_signature`, `discover_caps` and
`prepare_partition_batch` of the JAX package's `transforms/prepare.py`,
with the same arguments and the same numpy random draws. The padded batch
has numpy leaves (`device=None`) or, given a device, tensors there
(`data.padded.from_numpy`, `point_cloud_from_numpy`).
"""
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.data import Data
from ..data.pad import batch_nags, bucket, pad_nag, pad_point_cloud
from ..data.padded import from_numpy, point_cloud_from_numpy
from ..ops.graph import _round_up
from . import runtime as T
from .color import color_auto_contrast, color_drop
from .instance import on_the_fly_instance_graph

__all__ = ['BatchConfig', 'prepare_batch', 'process_batch',
           'batch_signature', 'discover_caps', 'prepare_partition_batch']


@dataclass
class BatchConfig:
    """The datamodule knobs that shape a training batch
    (configs/datamodule/semantic/s3dis.yaml)."""
    num_classes: int = 13
    point_hf: Sequence[str] = ('linearity', 'planarity', 'scattering',
                               'verticality', 'elevation', 'rgb')
    segment_hf: Sequence[str] = ()
    edge_hf: Sequence[str] = T.H_EDGE_KEYS_DEFAULT
    v_edge_hf: Sequence[str] = ()
    use_mean_normal: bool = False

    # sampling
    sample_point_min: int = 32
    sample_point_max: int = 128
    sample_graph_r: float = 7.0
    sample_graph_k: int = 4
    sample_graph_max_nodes: int = 10000
    sample_segment_ratio: float = 0.1
    sample_segment_by_size: bool = True
    sample_edge_n_max: int = -1
    max_num_nodes: int = 50000
    max_num_edges: int = 1000000

    # augmentations
    pos_jitter: float = 0.03
    voxel: float = 0.03
    tilt_n_rotate_phi: float = 0.1
    tilt_n_rotate_theta: float = 180
    anisotropic_scaling: float = 0.2
    node_feat_jitter: float = 0.01
    h_edge_feat_jitter: float = 0.01
    rgb_autocontrast: float = 0.5
    rgb_drop: float = 0.3

    # instance graph (panoptic)
    instance: bool = False
    instance_k_max: int = 30
    instance_radius: float = 0.1
    instance_adjacency_mode: str = 'radius-atomic'

    # padding
    node_caps: Optional[Dict[int, int]] = None
    k_caps: Optional[Dict[int, int]] = None
    k_in_caps: Optional[Dict[int, int]] = None
    bucket_mode: str = 'pow2_fine'
    nano: bool = False


def process_batch(nag_list, cfg: BatchConfig, train=True, rng=None,
                  tta=False):
    """Transform phase of batch preparation: augment and sample each NAG,
    build features, batch; everything except padding. Returns the
    batched, transform-complete NAG, ready for `pad_nag` /
    `batch_signature`.

    `tta=True` applies the geometric augmentations WITHOUT any node or
    edge subsampling, so that every test-time-augmentation run sees
    every node.
    """
    if rng is None:
        rng = np.random.default_rng()
    augment = train or tta
    sample = train and not tta
    processed = []
    for nag in nag_list:
        if cfg.nano and nag.start_i_level == 0:
            raise ValueError(
                "nano batch configs expect NAGs loaded without level 0 "
                "(start_i_level >= 1, reference nano datasets load with "
                "low=1); got a NAG rooted at level 0")
        nag = nag.clone()
        nag = T.node_size(nag, low=0 if not cfg.nano else 1)
        if sample:
            nag = T.sample_sub_nodes(
                nag, rng, low=nag.start_i_level,
                high=nag.start_i_level + 1,
                n_min=cfg.sample_point_min, n_max=cfg.sample_point_max)
            if cfg.sample_graph_r > 0:
                nag = T.sample_radius_subgraphs(
                    nag, rng, r=cfg.sample_graph_r,
                    k=cfg.sample_graph_k, i_level=1,
                    k_max=cfg.sample_graph_max_nodes)
            if cfg.sample_segment_ratio > 0:
                nag = T.sample_segments(
                    nag, rng, ratio=cfg.sample_segment_ratio,
                    by_size=cfg.sample_segment_by_size)
            nag = T.restrict_size(nag, rng, num_nodes=cfg.max_num_nodes)
        if augment:
            nag = T.jitter_key(nag, rng, key='pos',
                               sigma=cfg.pos_jitter, trunc=cfg.voxel)
            nag = T.random_tilt_and_rotate(
                nag, rng, phi=cfg.tilt_n_rotate_phi,
                theta=cfg.tilt_n_rotate_theta)
            nag = T.random_anisotropic_scale(
                nag, rng, delta=cfg.anisotropic_scaling)
            nag = T.random_axis_flip(nag, rng, p=0.5)
        nag = T.on_the_fly_horizontal_edge_features(
            nag, keys=cfg.edge_hf, use_mean_normal=cfg.use_mean_normal)
        if cfg.v_edge_hf:
            nag = T.on_the_fly_vertical_edge_features(
                nag, keys=cfg.v_edge_hf,
                use_mean_normal=cfg.use_mean_normal)
        if sample and cfg.sample_edge_n_max > 0:
            nag = T.sample_edges(nag, rng, n_max=cfg.sample_edge_n_max)
        if sample:
            nag = T.restrict_size(nag, rng, num_edges=cfg.max_num_edges)
        if train:
            # feature noise + color augmentations (reference
            # on_device_train_transform, default.yaml:292-365)
            for k in cfg.point_hf:
                if k != 'rgb':
                    nag = T.jitter_key(
                        nag, rng, key=k, sigma=cfg.node_feat_jitter,
                        trunc=2 * cfg.node_feat_jitter)
            nag = T.jitter_key(nag, rng, key='edge_attr',
                               sigma=cfg.h_edge_feat_jitter,
                               trunc=2 * cfg.h_edge_feat_jitter)
            if cfg.rgb_autocontrast > 0 or cfg.rgb_drop > 0:
                for i in nag.levels:
                    if nag[i].get('rgb') is None:
                        continue
                    if cfg.rgb_autocontrast > 0:
                        color_auto_contrast(nag[i], rng,
                                            p=cfg.rgb_autocontrast)
                    if cfg.rgb_drop > 0:
                        color_drop(nag[i], rng, p=cfg.rgb_drop)
        nag = T.add_self_loops(nag)
        if cfg.instance:
            nag = on_the_fly_instance_graph(
                nag, level=1, num_classes=cfg.num_classes,
                k_max=cfg.instance_k_max, radius=cfg.instance_radius,
                adjacency_mode=cfg.instance_adjacency_mode)

        # handcrafted features -> x
        if not cfg.nano and cfg.point_hf:
            nag.add_keys_to(nag.start_i_level, list(cfg.point_hf),
                            to='x', delete_after=False)
        if cfg.segment_hf:
            nag.add_keys_to('1+', list(cfg.segment_hf), to='x',
                            delete_after=False)
        processed.append(nag)

    return batch_nags(processed)


def prepare_batch(nag_list, cfg: BatchConfig, train=True, rng=None,
                  tta=False, device=None):
    """Full batch preparation: `process_batch` then `pad_nag`. Returns
    a `PaddedNAG` with numpy leaves when `device` is None, else
    `from_numpy(..., device, train=train)` of it (f32 features)."""
    big = process_batch(nag_list, cfg, train=train, rng=rng, tta=tta)
    host = pad_nag(big, num_classes=cfg.num_classes,
                   node_caps=cfg.node_caps, k_caps=cfg.k_caps,
                   k_in_caps=cfg.k_in_caps, bucket_mode=cfg.bucket_mode)
    if device is None:
        return host
    return from_numpy(host, device, train=train)


def batch_signature(big, cfg: BatchConfig, with_edges_from=1):
    """Padded-shape signature of a transform-complete batched NAG
    WITHOUT materializing any padded array: per-level node capacity
    (bucketed), dense-neighbor K (max out-degree, 16-rounded) and
    transpose-table K_in (max in-degree, 16-rounded), exactly the
    shapes `pad_nag` would choose. Returns (node_caps, k_caps,
    k_in_caps) dicts keyed by absolute level."""
    node_caps, k_caps, k_in_caps = {}, {}, {}
    for i in big.levels:
        d = big[i]
        node_caps[i] = bucket(d.num_nodes, cfg.bucket_mode)
        if i >= with_edges_from and 'edge_index' in d \
                and d.num_edges > 0:
            ei = np.asarray(d.edge_index)
            deg = np.bincount(ei[0], minlength=d.num_nodes)
            k_caps[i] = max(_round_up(int(deg.max(initial=0)), 16), 16)
            deg_in = np.bincount(ei[1], minlength=d.num_nodes)
            k_in_caps[i] = max(
                _round_up(int(deg_in.max(initial=0)), 16), 16)
    return node_caps, k_caps, k_in_caps


def discover_caps(nag_lists, cfg: BatchConfig, train=True, rng=None,
                  headroom_levels=1):
    """Probe a few batches and fix per-level node and K capacities, so
    that every training step sees one padded signature.

    :param nag_lists: iterable of batch inputs (lists of NAGs)
    :param headroom_levels: extra pow2 doublings on node caps
    :return: a new BatchConfig with node_caps / k_caps / k_in_caps pinned
    """
    rng = rng or np.random.default_rng(0)
    node_caps, k_caps, k_in_caps = {}, {}, {}
    for nags in nag_lists:
        b = prepare_batch(list(nags), cfg, train=train, rng=rng)
        for i, lvl in enumerate(b.levels):
            li = b.start_i_level + i
            node_caps[li] = max(node_caps.get(li, 0), lvl.capacity)
            if lvl.nbr_idx is not None:
                k_caps[li] = max(k_caps.get(li, 0),
                                 lvl.nbr_idx.shape[1])
            if lvl.nbr_in_idx is not None:
                k_in_caps[li] = max(k_in_caps.get(li, 0),
                                    lvl.nbr_in_idx.shape[1])
    for li in node_caps:
        node_caps[li] <<= headroom_levels
    # K_in tracks the max observed in-degree, which varies batch to
    # batch: one 16-slot step of headroom
    for li in k_in_caps:
        k_in_caps[li] += 16
    return dataclasses.replace(
        cfg, node_caps=node_caps, k_caps=k_caps or None,
        k_in_caps=k_in_caps or None)


def prepare_partition_batch(nag_list, cfg: BatchConfig, train=True,
                            rng=None, knn_adjacency=10, voxel=None,
                            node_cap=None, edge_cap=None, device=None):
    """Batch preparation for EZ-SP's partition stage: the level-0 voxels
    of each NAG, their `cfg.point_hf` features (rgb over 1.5 rescaled by
    1/255), a KNN adjacency (`knn_adjacency` neighbors, rebuilt with the
    native KNN, as cached NAGs drop it), quantized coordinates at the
    stored grid size (or `voxel`), and in training a random crop to
    `cfg.max_num_nodes` voxels with its adjacency rebuilt; then
    `pad_point_cloud`. Returns a `PaddedPointCloud` with numpy leaves
    when `device` is None, else of tensors on `device`."""
    from .preprocess import (adjacency_graph, knn_search,
                             quantize_coordinates)

    if rng is None:
        rng = np.random.default_rng()
    datas = []
    for nag in nag_list:
        d0 = nag[0]
        pos = np.asarray(d0.pos, np.float32)
        feats = []
        for k in cfg.point_hf:
            v = d0.get(k)
            if v is None:
                continue
            v = np.asarray(v, np.float32).reshape(pos.shape[0], -1)
            if k == 'rgb' and v.max() > 1.5:
                v = v / 255.0
            feats.append(v)
        x = np.concatenate(feats, 1) if feats else \
            np.zeros((pos.shape[0], 1), np.float32)
        d = Data(pos=pos, x=x, y=d0.get('y'))
        d = knn_search(d, k=knn_adjacency, r_max=np.inf)
        d = adjacency_graph(d, k=knn_adjacency)
        vox = voxel if voxel is not None else float(
            np.asarray(d0.get('grid_size', 0.04)).reshape(-1)[0])
        d = quantize_coordinates(d, size=max(vox, 1e-6))
        if train and cfg.max_num_nodes and \
                pos.shape[0] > cfg.max_num_nodes:
            keep = rng.choice(pos.shape[0], cfg.max_num_nodes,
                              replace=False)
            keep.sort()
            d, _ = d.select(keep)
            d = knn_search(d, k=knn_adjacency, r_max=np.inf)
            d = adjacency_graph(d, k=knn_adjacency)
        datas.append(d)
    host = pad_point_cloud(
        datas, num_classes=cfg.num_classes, node_cap=node_cap,
        edge_cap=edge_cap, bucket_mode=cfg.bucket_mode)
    if device is None:
        return host
    return point_cloud_from_numpy(host, device)

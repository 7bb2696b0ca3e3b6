"""SuperCluster panoptic segmentation: the SPT backbone, one classifier
head per supervised level and a symmetric edge-affinity head on the
level-1 instance graph. Counterparts of `PanopticSegmentationModel`,
`PanopticTask`, `_weighted_bce_with_logits`, `instance_partition` and
`grid_search_panoptic_partition` in
`superpoint_transformer_tpu/models/panoptic.py`.

Instances are recovered at inference, on the host, by an L0
graph-clustering partition whose inputs are the predicted class logits
(node features) and edge affinities (cut costs), solved by the native
greedy solver of the preprocessing partition (`ops/native.py`). The
partition, the stuff merge and the metrics are numpy, as in the JAX
package. `instance_classes` classes each instance of a partition by its
summed logits, for serving (`inference.infer_panoptic_batch`) and
validation alike.

The forward runs in one `spt.forward` span, the edge-affinity head in
an `spt.affinity` span inside it (its gathers in their `spt.gather`
spans). `instance_partition.calls`, `.nodes`, `.edges` and `.instances`
count the partitions made since import, the nodes and edges they were
given and the instances they returned (the `partition.*` counters).
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.panoptic import PanopticQuality3D
from ..nn.mlp import FFN, Classifier
from ..ops.native import greedy_cut
from ..ops.segment import gather_rows
from ..utils.profiling import annotate
from .semantic import SemanticTask

__all__ = ['PanopticSegmentationModel', 'PanopticTask',
           'instance_partition', 'instance_classes',
           'grid_search_panoptic_partition']


class PanopticSegmentationModel(nn.Module):
    """The SPT backbone `net`, one classifier head per supervised level,
    and `edge_affinity_head`, an FFN over the symmetric pair encoding
    [|xi - xj|, (xi + xj) / 2] of the level-1 features at the ends of
    each `obj_edge_index` edge. Made on `device` (by default the device
    of `net`)."""

    def __init__(self, net, num_classes, edge_affinity_hidden=32,
                 device=None):
        super().__init__()
        if device is None:
            device = next(net.parameters()).device
        self.net = net
        self.num_classes = num_classes
        for i, d in enumerate(net.out_dim):
            self.add_module(f'head_{i}',
                            Classifier(d, num_classes, device=device))
        d1 = 2 * net.out_dim[0]
        self.edge_affinity_head = FFN(d1, hidden_dim=edge_affinity_hidden,
                                      out_dim=1, device=device)

    def forward(self, nag):
        """(logits of levels 1..L, low to high, each [N_i, num_classes]
        f32; edge-affinity logits [Eo] f32 for every padded
        `obj_edge_index` edge, or None without an instance graph)."""
        with annotate('spt.forward'):
            outs = self.net(nag)
            logits = [getattr(self, f'head_{i}')(x)
                      for i, x in enumerate(outs)]
            lvl1 = nag[1]
            ea_logits = None
            if lvl1.obj_edge_index is not None:
                with annotate('spt.affinity'):
                    # gathers as embedding lookups: the backward of
                    # advanced indexing is slow on the card
                    # (ops/segment.py:gather_rows)
                    xi = gather_rows(outs[0], lvl1.obj_edge_index[0])
                    xj = gather_rows(outs[0], lvl1.obj_edge_index[1])
                    ef = torch.cat([(xi - xj).abs(), (xi + xj) * 0.5],
                                   dim=1)
                    ea_logits = self.edge_affinity_head(ef)[:, 0]
            return logits, ea_logits


def _weighted_bce_with_logits(logits, target, weight=None, mask=None):
    """Binary cross-entropy with logits, averaged over the edges with
    per-edge weights `weight` (default 1) times `mask`."""
    per = -(target * F.logsigmoid(logits)
            + (1 - target) * F.logsigmoid(-logits))
    w = torch.ones_like(per) if weight is None else weight
    if mask is not None:
        w = w * mask.to(per.dtype)
    return (per * w).sum() / w.sum().clamp(min=1e-12)


class PanopticTask(SemanticTask):
    """The semantic task's loss plus `edge_affinity_loss_lambda` times the
    edge-affinity BCE, whose edges are weighted by the 4 cases of
    (same class, same object) as `edge_affinity_loss_weights` gives them.
    The model, its edge-affinity head included, exists before the
    optimizer's groups are formed; the head trains at the base LR.
    Batches carry the level-1 instance graph (`prepare_batch` with
    `BatchConfig(instance=True)`) and the label histograms
    (`from_numpy(..., train=True)`), for evaluation too."""
    parallel_steps = False

    def __init__(self, net, num_classes=13, edge_affinity_loss_lambda=1.0,
                 edge_affinity_loss_weights=(1., 1., 1., 1.),
                 stuff_classes=(), **kwargs):
        self.edge_affinity_loss_lambda = edge_affinity_loss_lambda
        self.edge_affinity_loss_weights = edge_affinity_loss_weights
        self.stuff_classes = tuple(stuff_classes)
        super().__init__(net, num_classes=num_classes, **kwargs)

    def _make_model(self, net, num_classes):
        return PanopticSegmentationModel(net, num_classes)

    def forward_loss(self, batch):
        """(loss, logits of levels 1..L, edge-affinity logits or None) in
        the model's current mode."""
        logits, ea_logits = self.model(batch)
        loss = self._semantic_loss(logits, batch)
        lvl1 = batch[1]
        if ea_logits is not None and lvl1.obj_edge_affinity is not None:
            target = lvl1.obj_edge_affinity
            # padded edges point at node 0: obj_edge_mask drops them
            ea_loss = _weighted_bce_with_logits(
                ea_logits, target, weight=self._edge_weights(batch, target),
                mask=lvl1.obj_edge_mask)
            loss = loss + self.edge_affinity_loss_lambda * ea_loss
        return loss, logits, ea_logits

    def loss(self, batch):
        """(loss, logits of levels 1..L), as the semantic task's."""
        loss, logits, _ = self.forward_loss(batch)
        return loss, logits

    def _edge_weights(self, batch, target):
        """Per-edge weight of the 4 cases (same class and object, same
        class only, same object only, neither), the class of a node being
        the argmax of its label histogram; None without 4 weights or
        labels."""
        w = self.edge_affinity_loss_weights
        if w is None or len(w) != 4:
            return None
        lvl1 = batch[1]
        if lvl1.y is None:
            return None
        y = lvl1.y.argmax(1)
        s, t = lvl1.obj_edge_index
        same_class = y[s] == y[t]
        same_obj = target > 0.5
        ws = torch.as_tensor(w, dtype=torch.float32, device=target.device)
        return torch.where(
            same_class & same_obj, ws[0],
            torch.where(same_class & ~same_obj, ws[1],
                        torch.where(~same_class & same_obj, ws[2], ws[3])))

    @torch.no_grad()
    def eval_step(self, batch):
        """Loss, confusion matrix, level-1 logits and the edge-affinity
        logits of every padded edge, in evaluation mode."""
        self.model.eval()
        loss, logits, ea_logits = self.forward_loss(batch)
        return {'loss': loss, 'confmat': self._confmat(logits, batch),
                'logits_level1': logits[0],
                'edge_affinity_logits': ea_logits}


def instance_partition(
        pos, node_logits, edge_index, edge_affinity_logits,
        node_size=None, regularization=10.0, x_weight=5e-2,
        p_weight=1.0, cutoff=1, temperature=1.0, dampening=0.0,
        discrepancy_epsilon=1e-3, stuff_classes=(), num_classes=None,
        batch=None):
    """Instance partition by graph clustering, on the host:

      - edge weights: sigmoid(affinity) / (1 - sigmoid + eps)
      - node features: [x_weight * centered pos | p_weight * softmax
        probas], L2 metric on both
      - the L0 partition from the native greedy solver
      - all same-class stuff instances of a batch item merged

    Returns obj_index [N] instance ids.
    """
    from scipy.special import softmax as _softmax

    pos = np.asarray(pos)
    node_logits = np.asarray(node_logits)
    n = pos.shape[0]
    instance_partition.calls += 1
    instance_partition.nodes += n
    instance_partition.edges += int(edge_index.shape[1])
    if n < 2 or edge_index.shape[1] == 0:
        instance_partition.instances += min(n, 1)
        return np.zeros(n, dtype=np.int64)

    aff = 1.0 / (1.0 + np.exp(-np.asarray(edge_affinity_logits)))
    discrepancy = aff / (1 - aff + discrepancy_epsilon)

    probas = _softmax(node_logits / temperature, axis=1)
    C = probas.shape[1]
    probas = (1 - dampening) * probas + dampening / C

    x = np.concatenate(
        [(pos - pos.mean(0)) * x_weight, probas * p_weight],
        1).astype(np.float32)
    si, n_comp = greedy_cut(
        x, np.asarray(edge_index, dtype=np.int64),
        edge_weight=discrepancy.astype(np.float32),
        node_weight=(np.asarray(node_size, dtype=np.float32)
                     if node_size is not None else None),
        reg=regularization, cutoff=cutoff)

    # stuff merge: at most one instance per stuff class per batch item
    if stuff_classes is not None and len(stuff_classes):
        pred_cls = node_logits.argmax(1)
        batch = batch if batch is not None else np.zeros(n, np.int64)
        C = node_logits.shape[1]
        # majority predicted class per instance (vectorized histogram)
        hist = np.zeros((n_comp, C), dtype=np.int64)
        np.add.at(hist, (si, pred_cls), 1)
        comp_cls = hist.argmax(1)
        comp_batch = np.zeros(n_comp, dtype=np.int64)
        comp_batch[si] = batch
        # all stuff-class components of one (batch, class) collapse to
        # the first such component
        remap = np.arange(n_comp)
        is_stuff = np.isin(comp_cls, np.asarray(list(stuff_classes)))
        key = comp_batch * C + comp_cls
        stuff_idx = np.where(is_stuff)[0]
        if stuff_idx.size:
            order = stuff_idx[np.argsort(key[stuff_idx], kind='stable')]
            ks = key[order]
            first = np.ones(order.shape[0], bool)
            first[1:] = ks[1:] != ks[:-1]
            group_first = order[np.maximum.accumulate(
                np.where(first, np.arange(order.shape[0]), 0))]
            remap[order] = group_first
        si = remap[si]
        # re-compact
        _, si = np.unique(si, return_inverse=True)
    instance_partition.instances += int(si.max(initial=-1)) + 1
    return si


# partitions made since import, and the nodes, edges and instances of them
instance_partition.calls = 0
instance_partition.nodes = 0
instance_partition.edges = 0
instance_partition.instances = 0


def instance_classes(obj_index, node_logits):
    """(class [n_inst] int64, score [n_inst] f64) of each instance of a
    partition: the argmax of its nodes' summed logits, and the largest
    softmax probability of that sum. `obj_index` [N] holds instance ids
    0..n_inst-1; the sums run over each instance's rows in row order, in
    the logits' dtype."""
    logits = np.asarray(node_logits)
    obj_index = np.asarray(obj_index)
    n_inst = int(obj_index.max(initial=-1)) + 1
    s = np.zeros((n_inst, logits.shape[1]), dtype=logits.dtype)
    np.add.at(s, obj_index, logits)
    p = np.exp(s - s.max(1, keepdims=True))
    return s.argmax(1), (p / p.sum(1, keepdims=True)).max(1).astype(
        np.float64)


def grid_search_panoptic_partition(
        pos, node_logits, edge_index, edge_affinity_logits, obj,
        num_classes, node_size=None, batch=None, stuff_classes=(),
        regularizations=(1., 10., 20., 50., 100., 200.),
        x_weights=(2e-1, 5e-2, 1e-2), cutoffs=(1, 100, 300),
        criterion='pq'):
    """Grid-search the instance-partition settings that maximize a
    panoptic metric (`criterion` of `PanopticQuality3D.compute`).

    :param obj: InstanceData of the gt overlaps of each level-1 node
    :return: (best settings dict, best metrics dict, best obj_index)
    """
    best = (None, None, None)
    best_score = -np.inf
    for reg in regularizations:
        for xw in x_weights:
            for cut in cutoffs:
                obj_index = instance_partition(
                    pos, node_logits, edge_index,
                    edge_affinity_logits, node_size=node_size,
                    regularization=reg, x_weight=xw, cutoff=cut,
                    stuff_classes=stuff_classes,
                    num_classes=num_classes, batch=batch)
                merged = obj.merge(obj_index)
                n_inst = int(obj_index.max()) + 1
                logits_np = np.asarray(node_logits)
                acc = np.zeros((n_inst, logits_np.shape[1]))
                np.add.at(acc, obj_index, logits_np)
                pred_sem = acc.argmax(1)
                pq = PanopticQuality3D(
                    num_classes, stuff_classes=stuff_classes)
                pq.update_from_instance_data(merged, pred_sem)
                metrics = pq.compute()
                score = metrics[criterion]
                if score > best_score:
                    best_score = score
                    best = (dict(regularization=reg, x_weight=xw,
                                 cutoff=cut), metrics, obj_index)
    return best

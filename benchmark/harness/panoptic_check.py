"""The numbers that decide `correct` in a panoptic serving cell: every
answer of the window (`inference.PanopticAnswer`: an instance id and the
class of its instance a level-1 node, the edge-affinity logits of the
instance graph and the level-1 logits) read against the plain
reference's answer on its batch (`reference/panoptic.py:answer`). Limits
in `limits/<cell>.json`; the numbers without one are recorded beside
them.

- `pred_gap_mean`: the class gap, as a semantic cell's: for each served
  instance, the gap by which the reference's summed logits of its nodes
  at the served class lie below their best, over its nodes, given to
  each of them; the mean over a request's nodes, at the worst request
  (a node alone in its instance reads the semantic cell's gap);
- `affinity_gap`: the median absolute gap between the served and the
  reference's edge-affinity logits over the valid edges of a request, at
  the worst request (`affinity_gap_mean`, `affinity_gap_max`: the mean
  and the widest, recorded);
- `energy_gap`: the partition against the reference's greedy partition
  of the same inputs. The served logits and affinities, with the batch's
  positions and sizes, give the partition's inputs
  (`reference/panoptic.py:partition_inputs`). The served instances and
  the reference's (its greedy partition of those inputs, then its stuff
  merge) are each cut into their connected pieces over the instance
  graph, which undoes most of the stuff merge (pieces of one stuff
  instance that an edge joins stay joined, on both sides alike); the
  excess of the served pieces' L0 energy under those inputs over the
  reference's, over the latter, at the worst request. One-sided: the
  program's solver may do better. The same read under the reference's
  own float32 inputs and partition (`energy_gap_ref_inputs`, recorded)
  holds the head's bf16 noise, which the edge weights
  sigma(a) / (1 - sigma(a) + 1e-3) raise to the exponential;
- `stuff_split`: of the nodes served with a stuff class, the share that
  lies outside the largest instance of that class in their graph (tile),
  over a request, at the worst request (0 where the stuff merge has
  merged them).
"""
import hashlib

import numpy as np

from ..reference import panoptic as ref

__all__ = ['panoptic_numbers', 'to_host_order']


def to_host_order(a, node_id):
    """An array in the NAG's row order, in the host batch's row order."""
    return np.asarray(a)[node_id]


def _class_gap(inst, cls, z):
    k = int(inst.max()) + 1
    s = np.zeros((k, z.shape[1]))
    np.add.at(s, inst, z.astype(np.float64))
    size = np.bincount(inst, minlength=k)
    return float(((s.max(1)[inst] - s[inst, cls]) / size[inst]).mean())


def _stuff_split(inst, cls, graph, stuff):
    outside, total = 0, 0
    for c in stuff:
        on = cls == c
        for g in np.unique(graph[on]):
            members = inst[on & (graph == g)]
            outside += members.shape[0] - int(np.bincount(members).max())
            total += members.shape[0]
    return outside / max(total, 1)


def _gap(e, best):
    return (e - best) / max(abs(best), 1e-30)


def _malformed(a, n, E, C):
    inst, cls, aff, z = (np.asarray(x) for x in a)
    return (inst.shape != (n,) or cls.shape != (n,) or aff.shape != (E,)
            or z.shape != (n, C) or not np.all(np.isfinite(aff))
            or not np.all(np.isfinite(z))
            or (n and (inst.min() < 0 or cls.min() < 0 or cls.max() >= C)))


def panoptic_numbers(refs, answers, settings, stuff_classes):
    """`refs`: {pool index: `reference/panoptic.py:answer`, with the
    batch's level-1 `pos` and `size` in host row order}; `answers`:
    [(pool index, PanopticAnswer)]. Returns ({name: value}, number of
    answers that were malformed)."""
    reg = settings['regularization']
    out = {'pred_gap_mean': 0.0, 'affinity_gap': 0.0,
           'affinity_gap_mean': 0.0, 'affinity_gap_max': 0.0,
           'energy_gap': -np.inf, 'energy_gap_ref_inputs': -np.inf,
           'stuff_split': 0.0}
    bad = 0
    e_ref = {b: ref.energy(r['features'], r['node_weight'], r['edges'],
                           r['edge_weight'], reg,
                           ref.connected_split(r['instance'], r['edges']))
             for b, r in refs.items()}
    best = {}     # the reference's energy on each distinct served input
    for b, a in answers:
        r = refs[b]
        (n, C), E = r['logits'].shape, r['edges'].shape[1]
        if _malformed(a, n, E, C):
            bad += 1
            continue
        nid = r['node_id']
        inst = np.unique(to_host_order(a[0], nid), return_inverse=True)[1]
        cls = to_host_order(a[1], nid).astype(np.int64)
        aff = np.asarray(a[2], np.float32)
        z = to_host_order(a[3], nid).astype(np.float32)
        if n:
            out['pred_gap_mean'] = max(out['pred_gap_mean'], _class_gap(
                inst, cls, r['logits']))
            out['stuff_split'] = max(out['stuff_split'], _stuff_split(
                inst, cls, r['graph'], stuff_classes))
        if E:
            gap = np.abs(aff.astype(np.float64) - r['edge_affinity'])
            for k, v in (('affinity_gap', np.median(gap)),
                         ('affinity_gap_mean', gap.mean()),
                         ('affinity_gap_max', gap.max())):
                out[k] = max(out[k], float(v))
        pieces = ref.connected_split(inst, r['edges'])
        out['energy_gap_ref_inputs'] = max(
            out['energy_gap_ref_inputs'], _gap(ref.energy(
                r['features'], r['node_weight'], r['edges'],
                r['edge_weight'], reg, pieces), e_ref[b]))
        f, w, ew = ref.partition_inputs(r['pos'], z, aff, r['size'],
                                        settings['x_weight'])
        key = (b, hashlib.sha1(z.tobytes() + aff.tobytes()).hexdigest())
        if key not in best:
            part = ref.stuff_merge(ref.greedy_partition(
                f, w, r['edges'], ew, reg, settings['cutoff']), z,
                r['graph'], stuff_classes)
            best[key] = ref.energy(f, w, r['edges'], ew, reg,
                                   ref.connected_split(part, r['edges']))
        out['energy_gap'] = max(out['energy_gap'], _gap(
            ref.energy(f, w, r['edges'], ew, reg, pieces), best[key]))
    for k in ('energy_gap', 'energy_gap_ref_inputs'):
        if not np.isfinite(out[k]):
            out[k] = 0.0
    return out, bad

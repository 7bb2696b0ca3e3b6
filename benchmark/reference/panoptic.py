"""The plain reference of SuperCluster's panoptic serving (Robert, Raguet
and Landrieu, "Scalable 3D Panoptic Segmentation As Superpoint Graph
Clustering", 3DV 2024, arXiv:2401.06704), written from the equations in
plain PyTorch and numpy. It imports nothing of the measured program.

For a padded host batch with a level-1 instance graph (edges (u, v) of
superpoints with points within the instance radius):

1. the SPT backbone and its level-1 classifier (`reference/spt.py`);
2. the edge-affinity head: a_uv = FFN([|x_u - x_v|, (x_u + x_v) / 2]),
   FFN = Linear -> LeakyReLU(0.01) -> Linear to one logit, in float32,
   on the level-1 features x of the backbone;
3. the partition's inputs: node features f_p = [x_weight * (pos_p -
   mean pos) | softmax(logits_p)], node weights w_p = the superpoint's
   size, edge weights w_uv = sigma(a_uv) / (1 - sigma(a_uv) + 1e-3);
4. the L0 (Potts) energy of a partition P of the nodes,
     E(P) = sum_p w_p ||f_p - mu_c(p)||^2 + reg * sum_{cut (u,v)} w_uv,
   mu_c the weighted mean of component c, summed in float64;
5. a greedy partition (`greedy_partition`): from singletons, merge the
   adjacent pair of components with the largest gain
     reg * W_AB - S_A S_B / (S_A + S_B) ||mu_A - mu_B||^2
   while one is positive, then merge each component lighter than
   `cutoff` into the neighbor of largest gain;
6. the stuff merge: in each graph (tile), every component whose
   majority predicted class is a stuff class joins the other components
   of that class;
7. each instance's class: the argmax of its nodes' summed logits.

Departures from the published description: the partition of step 5 is
the greedy merge alone (the published model calls cut pursuit's L0
solver, whose result the greedy merge only approaches: the energy gap
of the check is one-sided for this reason); the weights are drawn at
random (`harness/panoptic_weights.py`), not trained; the level-1
features are read off the backbone's forward through an identity
level-1 head (an exact copy in float32 with TF32 off).
"""
import heapq

import numpy as np
import torch
import torch.nn.functional as F

from . import spt

__all__ = ['head_shapes', 'param_shapes', 'forward', 'partition_inputs',
           'energy', 'greedy_partition', 'stuff_merge', 'instance_classes',
           'connected_split', 'answer', 'EPS']

EPS = 1e-3               # the edge weights' epsilon
SLOPE = 0.01


def head_shapes(m):
    """[(name, shape)] of the edge-affinity head's parameters, named as
    the program's `state_dict` names them."""
    c, h = m['up_dim'][-1], m['edge_affinity_hidden']
    p = 'edge_affinity_head'
    return [(f'{p}.linear_0.weight', (h, 2 * c)), (f'{p}.linear_0.bias', (h,)),
            (f'{p}.linear_1.weight', (1, h)), (f'{p}.linear_1.bias', (1,))]


def param_shapes(m):
    """The backbone's and heads' parameters (`spt.param_shapes`), then
    the edge-affinity head's."""
    return spt.param_shapes(m) + head_shapes(m)


def _round(x, qdt):
    return x if qdt is None else spt._round(x, qdt)


def forward(m, p, levels, G, edges, qdtype=None):
    """(level-1 logits [n1, num_classes], edge-affinity logits [E]) of
    the levels of `spt.levels_from_host` and the instance graph `edges`
    [2, E] (int64 tensor of level-1 rows), from the parameters `p`. With
    `qdtype`, the backbone and the head round as `spt.forward` does."""
    c, dev = m['up_dim'][-1], levels[0]['pos'].device
    q = dict(p)
    q['head_0.classifier.weight'] = torch.eye(c, device=dev)
    q['head_0.classifier.bias'] = torch.zeros(c, device=dev)
    x = spt.forward(m, q, levels, G, qdtype)[0]
    logits = x @ p['head_0.classifier.weight'].t() \
        + p['head_0.classifier.bias']
    xi, xj = x[edges[0]], x[edges[1]]
    e = _round(torch.cat([(xi - xj).abs(), (xi + xj) * 0.5], 1), qdtype)
    h = 'edge_affinity_head'
    y = spt._linear(e, p[f'{h}.linear_0.weight'], p[f'{h}.linear_0.bias'],
                    qdtype)
    y = _round(F.leaky_relu(y, SLOPE), qdtype)
    y = spt._linear(y, p[f'{h}.linear_1.weight'], p[f'{h}.linear_1.bias'],
                    qdtype)
    return logits, y[:, 0]


def partition_inputs(pos, logits, aff_logits, node_size, x_weight):
    """(node features [n, 3 + C], node weights [n], edge weights [E]),
    float32 numpy, from level-1 positions, logits, edge-affinity logits
    and sizes (step 3)."""
    pos = np.asarray(pos, np.float32)
    z = torch.as_tensor(np.asarray(logits, np.float32))
    prob = torch.softmax(z, 1).numpy()
    centred = (pos - pos.astype(np.float64).mean(0)).astype(np.float32)
    f = np.concatenate([centred * np.float32(x_weight), prob], 1)
    s = 1.0 / (1.0 + np.exp(-np.asarray(aff_logits, np.float64)))
    w = (s / (1.0 - s + EPS)).astype(np.float32)
    return f.astype(np.float32), np.asarray(node_size, np.float32), w


def energy(f, node_w, edges, edge_w, reg, part):
    """E(P) of partition `part` [n] (component ids) in float64 (step
    4)."""
    f = np.asarray(f, np.float64)
    w = np.asarray(node_w, np.float64)
    part = np.unique(np.asarray(part), return_inverse=True)[1]
    k = int(part.max(initial=-1)) + 1
    s = np.bincount(part, weights=w, minlength=k)
    mu = np.stack([np.bincount(part, weights=w * f[:, j], minlength=k)
                   for j in range(f.shape[1])], 1) \
        / np.maximum(s, 1e-300)[:, None]
    fid = float((w * ((f - mu[part]) ** 2).sum(1)).sum())
    u, v = np.asarray(edges[0]), np.asarray(edges[1])
    cut = part[u] != part[v]
    return fid + float(reg) * float(np.asarray(edge_w, np.float64)[cut].sum())


def greedy_partition(f, node_w, edges, edge_w, reg, cutoff):
    """The greedy partition of step 5: component ids [n] int64,
    compact. Edges given twice, or in both directions, add
    their weights; self-loops are ignored."""
    f = np.asarray(f, np.float64)
    n = f.shape[0]
    S = np.asarray(node_w, np.float64).copy()
    mu = [f[i].copy() for i in range(n)]
    adj = [dict() for _ in range(n)]
    for u, v, w in zip(np.asarray(edges[0]).tolist(),
                       np.asarray(edges[1]).tolist(),
                       np.asarray(edge_w, np.float64).tolist()):
        if u != v:
            adj[u][v] = adj[u].get(v, 0.0) + w
            adj[v][u] = adj[v].get(u, 0.0) + w
    alive = np.ones(n, bool)
    version = np.zeros(n, np.int64)
    parent = np.arange(n)

    def gain(a, b):
        d = mu[a] - mu[b]
        return reg * adj[a][b] - S[a] * S[b] / (S[a] + S[b]) * float(d @ d)

    def merge(a, b):
        s = S[a] + S[b]
        mu[a] = (mu[a] * S[a] + mu[b] * S[b]) / s
        S[a] = s
        alive[b] = False
        parent[b] = a
        version[a] += 1
        version[b] += 1
        del adj[a][b]
        del adj[b][a]
        for c, w in adj[b].items():
            adj[a][c] = adj[a].get(c, 0.0) + w
            del adj[c][b]
            adj[c][a] = adj[a][c]
        adj[b] = {}

    heap = []

    def push(a):
        for b in adj[a]:
            g = gain(a, b)
            if g > 0:
                heapq.heappush(heap, (-g, a, b, version[a], version[b]))

    for a in range(n):
        push(a)
    while heap:
        _, a, b, va, vb = heapq.heappop(heap)
        if not (alive[a] and alive[b]) or version[a] != va \
                or version[b] != vb:
            continue
        merge(a, b)
        push(a)
    if cutoff > 0:
        changed = True
        while changed:
            changed = False
            for a in range(n):
                if not alive[a] or S[a] >= cutoff or not adj[a]:
                    continue
                best = max(adj[a], key=lambda b: gain(a, b))
                merge(best, a)
                changed = True

    def root(i):
        while parent[i] != i:
            i = parent[i]
        return i

    roots = np.array([root(i) for i in range(n)])
    return np.unique(roots, return_inverse=True)[1].astype(np.int64) \
        if n else roots.astype(np.int64)


def stuff_merge(part, logits, graph, stuff_classes):
    """Step 6 on partition `part` [n]: returns the merged component ids
    [n], compact."""
    part = np.asarray(part)
    if not len(stuff_classes) or part.size == 0:
        return part
    pred = np.asarray(logits).argmax(1)
    C = np.asarray(logits).shape[1]
    k = int(part.max()) + 1
    counts = np.zeros((k, C), np.int64)
    np.add.at(counts, (part, pred), 1)
    major = counts.argmax(1)
    comp_graph = np.zeros(k, np.int64)
    comp_graph[part] = np.asarray(graph)
    target = np.arange(k)
    for g in np.unique(comp_graph):
        for c in stuff_classes:
            members = np.flatnonzero((comp_graph == g) & (major == c))
            if members.size:
                target[members] = members[0]
    return np.unique(target[part], return_inverse=True)[1].astype(np.int64)


def instance_classes(part, logits):
    """Step 7: the class [k] of each component of `part` [n]."""
    part = np.asarray(part)
    z = np.asarray(logits, np.float64)
    s = np.zeros((int(part.max(initial=-1)) + 1, z.shape[1]))
    np.add.at(s, part, z)
    return s.argmax(1)


def connected_split(part, edges):
    """Each component of `part` [n] cut into its connected pieces over
    the edges [2, E] inside it: component ids [n], compact."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    part = np.asarray(part)
    n = part.shape[0]
    u, v = np.asarray(edges[0]), np.asarray(edges[1])
    keep = part[u] == part[v]
    g = coo_matrix((np.ones(int(keep.sum())), (u[keep], v[keep])),
                   shape=(n, n))
    return connected_components(g, directed=False)[1].astype(np.int64)


def answer(m, p, host, settings, stuff_classes, device, qdtype=None):
    """The reference's panoptic answer of a host batch, every array in
    the host batch's row order (level 1) and edge order (its valid
    edges): {'logits', 'edge_affinity', 'edges', 'features',
    'node_weight', 'edge_weight', 'graph', 'greedy' (step 5), 'instance'
    (step 6), 'cls' (step 7, a node), 'node_id', and the batch's 'pos'
    and 'size'}."""
    levels = spt.levels_from_host(host, device)
    lvl = host.levels[1]
    n1 = int(lvl.num_nodes)
    emask = np.asarray(lvl.obj_edge_mask, bool)
    edges = np.asarray(lvl.obj_edge_index)[:, emask].astype(np.int64)
    with torch.no_grad():
        z, a = forward(m, p, levels, int(host.num_graphs),
                       torch.as_tensor(edges, device=device), qdtype)
    z = z.float().cpu().numpy()
    a = a.float().cpu().numpy()
    f, nw, ew = partition_inputs(lvl.pos[:n1], z, a, lvl.node_size[:n1],
                                 settings['x_weight'])
    greedy = greedy_partition(f, nw, edges, ew, settings['regularization'],
                              settings['cutoff'])
    graph = np.asarray(lvl.batch[:n1]).astype(np.int64)
    inst = stuff_merge(greedy, z, graph, stuff_classes)
    cls = instance_classes(inst, z)[inst]
    return {'logits': z, 'edge_affinity': a, 'edges': edges,
            'features': f, 'node_weight': nw, 'edge_weight': ew,
            'graph': graph, 'greedy': greedy, 'instance': inst, 'cls': cls,
            'node_id': np.asarray(lvl.node_id[:n1]).astype(np.int64),
            'pos': np.asarray(lvl.pos[:n1]),
            'size': np.asarray(lvl.node_size[:n1])}

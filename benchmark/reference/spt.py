"""The plain reference of the benchmarked models: an SPT semantic
segmentation network (Robert et al., "Efficient 3D Semantic Segmentation
with Superpoint Transformer", ICCV 2023, arXiv:2306.08045), its
multi-stage loss and its AdamW step, written from the equations in plain
PyTorch. It imports nothing of the measured program.

It runs on the valid rows of a padded host batch only (padding is cut
off before anything is computed) and in float32 (segment sums
accumulated in float64), or, for the
lower-precision control, with every value that the program rounds to its
compute dtype rounded to `qdtype` instead (float8 with a per-tensor
scale: e4m3 in the forward, e5m2 in the backward).

Network, for levels 0..L of a batch of G graphs (every MLP is
Linear -> GraphNorm -> LeakyReLU(0.01), `depth` times):

- edge MLPs: on level l = 1..L, the horizontal edge features of each
  valid neighbor slot through `h_edge_mlp_{l-1}`, normalized per graph;
- point stage on level 0: the positions normalized into the unit sphere
  of their level-1 superpoint (`unit_sphere`), the superpoint's diameter,
  and the point features, through `first_stage.in_mlp`;
- down stage l = 1..L: the children's features max-pooled into each
  node, with its normalized position and its parent's diameter (per
  graph at the top level), through `in_mlp`, then `down_num_blocks`
  pre-norm attention blocks;
- up stage at levels L-1..1: the skip features of the level and its
  parent's features, with the position injection, through `in_mlp`,
  then `up_num_blocks` blocks;
- heads: one Linear a supervised level (level 1 from the last up stage,
  the levels in between from the other up stages, the top level from
  the last down stage).

An attention block over node i's valid neighbor slots e = (i, j):
  h = GraphNorm(x); q, k, v = split(Linear_qkv(h));
  k_e = k_j + Linear_krpe(f_e), q_e = q_i + Linear_qrpe(f_e),
  v_e = v_j + Linear_vrpe(f_e)   (f_e the edge MLP's output);
  a_e = softmax_e(<q_e, k_e>_head * qk_dim^-1/2 * deg_i^-1/2);
  x <- x + Linear_out(sum_e a_e v_e).
"""
import math

import torch
import torch.nn.functional as F

__all__ = ['param_shapes', 'is_transformer_param', 'levels_from_host',
           'forward', 'multi_stage_loss', 'lr_at', 'adamw_step',
           'train_steps', 'flops_forward']

NORM_EPS = 1e-5
SLOPE = 0.01
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


# --------------------------------------------------------------------------
# parameters

def _widths(m):
    """The channel widths of model section `m` of a configuration file."""
    inj = 4                      # normalized xyz + the parent's diameter
    down, up, depth = m['down_dim'], m['up_dim'], m['mlp_depth']
    point = [m['point_hf_dim'] + inj] + list(m['point_mlp'])
    down_in = [[(point[-1] if i == 0 else down[i - 1]) + inj] + [d] * depth
               for i, d in enumerate(down)]
    up_in = []
    for i, d in enumerate(up):
        prev = down[-1] if i == 0 else up[i - 1]
        up_in.append([inj + prev + down[-(2 + i)]] + [d] * depth)
    edge = [m['edge_hf_dim']] + [m['h_edge_mlp_out']] * depth
    heads = list(up[::-1]) + [down[-1]]
    return point, down_in, up_in, edge, heads


def _mlp_shapes(prefix, dims):
    out = []
    for i in range(len(dims) - 1):
        out.append((f'{prefix}.linear_{i}.weight', (dims[i + 1], dims[i])))
        for leaf in ('weight', 'bias', 'mean_scale'):
            out.append((f'{prefix}.norm_{i}.{leaf}', (dims[i + 1],)))
    return out


def _block_shapes(prefix, C, m):
    H, D, R = m['num_heads'], m['qk_dim'], m['h_edge_mlp_out']
    out = [(f'{prefix}.sa_norm.{leaf}', (C,))
           for leaf in ('weight', 'bias', 'mean_scale')]
    for name, o, i in (('qkv', 2 * H * D + C, C), ('k_rpe', H * D, R),
                       ('q_rpe', H * D, R), ('v_rpe', C, R),
                       ('out_proj', C, C)):
        out += [(f'{prefix}.sa.{name}.weight', (o, i)),
                (f'{prefix}.sa.{name}.bias', (o,))]
    return out


def param_shapes(m):
    """[(name, shape)] of every parameter of the model of section `m`, in
    a fixed order, named as the measured program's `state_dict` names
    them (so that one set of drawn weights loads into both)."""
    point, down_in, up_in, edge, heads = _widths(m)
    out = []
    for i in range(len(m['down_dim'])):
        out += _mlp_shapes(f'net.h_edge_mlp_{i}', edge)
    out += _mlp_shapes('net.first_stage.in_mlp', point)
    for i, dims in enumerate(down_in):
        out += _mlp_shapes(f'net.down_stage_{i}.in_mlp', dims)
        for b in range(m['down_num_blocks']):
            out += _block_shapes(f'net.down_stage_{i}.block_{b}', dims[-1], m)
    for i, dims in enumerate(up_in):
        out += _mlp_shapes(f'net.up_stage_{i}.in_mlp', dims)
        for b in range(m['up_num_blocks']):
            out += _block_shapes(f'net.up_stage_{i}.block_{b}', dims[-1], m)
    for i, d in enumerate(heads):
        out += [(f'head_{i}.classifier.weight', (m['num_classes'], d)),
                (f'head_{i}.classifier.bias', (m['num_classes'],))]
    return out


def is_transformer_param(name):
    """The attention parameters, which train at the scaled LR."""
    return '.block_' in name and '.sa.' in name


# --------------------------------------------------------------------------
# inputs

def levels_from_host(batch, device, train=False):
    """The valid rows of each level of a padded host batch (numpy leaves),
    as dicts of float32 / int64 / bool tensors on `device`."""
    out = []
    for lvl in batch.levels:
        n = int(lvl.num_nodes)
        d = {'n': n,
             'pos': torch.as_tensor(lvl.pos[:n], device=device),
             'batch': torch.as_tensor(lvl.batch[:n], device=device).long(),
             'node_size': torch.as_tensor(lvl.node_size[:n], device=device)}
        if lvl.x is not None:
            d['x'] = torch.as_tensor(lvl.x[:n], device=device)
        if lvl.super_index is not None:
            d['super_index'] = torch.as_tensor(lvl.super_index[:n],
                                               device=device).long()
        if lvl.nbr_idx is not None:
            d['nbr_idx'] = torch.as_tensor(lvl.nbr_idx[:n],
                                           device=device).long()
            d['nbr_mask'] = torch.as_tensor(lvl.nbr_mask[:n], device=device)
            d['edge_feat'] = torch.as_tensor(lvl.edge_feat[:n],
                                             device=device)
        if train and lvl.y is not None:
            d['y'] = torch.as_tensor(lvl.y[:n], device=device)
        out.append(d)
    return out


# --------------------------------------------------------------------------
# rounding for the lower-precision control

class _Round(torch.autograd.Function):
    """Round to `dtype` in the forward and the gradient in the backward;
    float8 takes a per-tensor scale (amax onto the largest finite value)
    and the hybrid format of float8 training: e4m3 for values, e5m2 for
    gradients."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        dtype = FP8_DTYPES[1] if ctx.dtype in FP8_DTYPES else ctx.dtype
        return _round(g, dtype), None


def _round(x, dtype):
    if dtype in FP8_DTYPES:
        s = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
        return (x / s).to(dtype).to(x.dtype) * s
    return x.to(dtype).to(x.dtype)


def _r(x, qdt):
    return x if qdt is None else _Round.apply(x, qdt)


# --------------------------------------------------------------------------
# layers

def _linear(x, w, b, qdt):
    y = _r(x, qdt) @ _r(w, qdt).t()
    if b is not None:
        y = y + _r(b, qdt)
    return _r(y, qdt)


def _seg_sum(x, seg, n):
    """Per-segment sums of the rows of `x`, accumulated in float64 and
    returned in `x`'s dtype: a float32 running sum over millions of rows
    (one graph of a whole tile) drops addends under half its spacing."""
    return torch.zeros((n,) + x.shape[1:], dtype=torch.float64,
                       device=x.device).index_add(0, seg,
                                                  x.double()).to(x.dtype)


def graph_norm(x, graph, G, w, b, ms):
    """GraphNorm (Cai et al. 2021): per graph, x - mean_scale * mean over
    the graph's rows, over the square root of that shift's mean square
    plus eps, then an affine map."""
    cnt = _seg_sum(torch.ones_like(x[:, 0]), graph, G).clamp(min=1)[:, None]
    mean = _seg_sum(x, graph, G) / cnt
    xc = x - (ms * mean)[graph]
    var = _seg_sum(xc * xc, graph, G) / cnt
    return xc / torch.sqrt(var[graph] + NORM_EPS) * w + b


def _mlp(p, prefix, x, graph, G, qdt):
    i = 0
    x = _r(x, qdt)
    while f'{prefix}.linear_{i}.weight' in p:
        x = _linear(x, p[f'{prefix}.linear_{i}.weight'], None, qdt)
        n = f'{prefix}.norm_{i}'
        x = _r(graph_norm(x, graph, G, p[f'{n}.weight'], p[f'{n}.bias'],
                          p[f'{n}.mean_scale']), qdt)
        x = _r(F.leaky_relu(x, SLOPE), qdt)
        i += 1
    return x


def unit_sphere(pos, seg, nseg, weight):
    """Positions centred on their segment's weighted mean and divided by
    its diameter (largest extent over x, y, z) + 0.01; and the
    diameters [nseg]."""
    idx = seg[:, None].expand(-1, 3)
    mx = torch.full((nseg, 3), -math.inf, device=pos.device).scatter_reduce(
        0, idx, pos, 'amax')
    mn = torch.full((nseg, 3), math.inf, device=pos.device).scatter_reduce(
        0, idx, pos, 'amin')
    diam = (mx - mn).amax(1)
    w = _seg_sum(weight, seg, nseg).clamp(min=1e-12)
    centre = _seg_sum(pos * weight[:, None], seg, nseg) / w[:, None]
    return (pos - centre[seg]) / (diam[seg][:, None] + 1e-2), diam


def _max_pool(x, seg, n):
    idx = seg[:, None].expand(-1, x.shape[1])
    return torch.full((n, x.shape[1]), -math.inf, dtype=x.dtype,
                      device=x.device).scatter_reduce(0, idx, x, 'amax')


def _attention(p, pre, h, lvl, ef, m, qdt):
    n, K = lvl['nbr_idx'].shape
    H, D, C = m['num_heads'], m['qk_dim'], h.shape[1]
    DH = H * D
    s = f'{pre}.sa'
    qkv = _linear(h, p[f'{s}.qkv.weight'], p[f'{s}.qkv.bias'], qdt)
    q, kv = qkv[:, :DH], qkv[:, DH:]
    kvg = kv[lvl['nbr_idx']]                                  # [n, K, DH+C]
    rk, rq, rv = (_linear(ef, p[f'{s}.{r}.weight'], p[f'{s}.{r}.bias'], qdt)
                  for r in ('k_rpe', 'q_rpe', 'v_rpe'))
    k = _r(kvg[..., :DH] + rk, qdt).reshape(n, K, H, D)
    qe = _r(q[:, None] + rq, qdt).reshape(n, K, H, D)
    v = _r(kvg[..., DH:] + rv, qdt).reshape(n, K, H, C // H)
    mask = lvl['nbr_mask']
    deg = mask.sum(1).clamp(min=1).to(h.dtype)
    scale = D ** -0.5 * deg ** -0.5
    logit = torch.einsum('nkhd,nkhd->nkh', qe, k) * scale[:, None, None]
    logit = logit.masked_fill(~mask[:, :, None], -math.inf)
    a = torch.softmax(logit, 1)
    out = torch.einsum('nkh,nkhc->nhc', a, v).reshape(n, C)
    return _linear(out, p[f'{s}.out_proj.weight'], p[f'{s}.out_proj.bias'],
                   qdt)


def _stage(p, pre, x_in, lvl, seg, nseg, blocks, ef, G, m, qdt):
    npos, diam = unit_sphere(lvl['pos'], seg, nseg, lvl['node_size'])
    x = torch.cat([diam[seg][:, None], npos, x_in], 1)
    x = _mlp(p, f'{pre}.in_mlp', x, lvl['batch'], G, qdt)
    for b in range(blocks):
        bp = f'{pre}.block_{b}'
        h = graph_norm(x, lvl['batch'], G, p[f'{bp}.sa_norm.weight'],
                       p[f'{bp}.sa_norm.bias'], p[f'{bp}.sa_norm.mean_scale'])
        x = x + _attention(p, bp, h, lvl, ef, m, qdt)
    return x


def _edge_features(p, i, lvl, G, qdt):
    """The edge MLP's output on each valid slot of a level, zero on the
    others: [n, K, h_edge_mlp_out]."""
    mask = lvl['nbr_mask']
    n, K = mask.shape
    src = torch.arange(n, device=mask.device)[:, None].expand(n, K)[mask]
    e = _mlp(p, f'net.h_edge_mlp_{i}', lvl['edge_feat'][mask],
             lvl['batch'][src], G, qdt)
    out = torch.zeros((n, K, e.shape[1]), dtype=e.dtype, device=e.device)
    out[mask] = e
    return out


def forward(m, p, levels, G, qdtype=None):
    """Logits [n_l, num_classes] of levels 1..L (valid rows), from the
    parameters `p` (name -> tensor) of model section `m` and the levels
    of `levels_from_host`, for a batch of G graphs."""
    qdt = qdtype
    L = len(levels) - 1
    num_down, num_up = len(m['down_dim']), len(m['up_dim'])
    assert num_down == L, (num_down, L)
    efs = {l: _edge_features(p, l - 1, levels[l], G, qdt)
           for l in range(1, L + 1)}
    l0 = levels[0]
    x = _stage(p, 'net.first_stage', l0['x'], l0, l0['super_index'],
               levels[1]['n'], 0, None, G, m, qdt)
    down = {}
    for l in range(1, L + 1):
        lvl = levels[l]
        pooled = _max_pool(x, levels[l - 1]['super_index'], lvl['n'])
        if l < L:
            seg, nseg = lvl['super_index'], levels[l + 1]['n']
        else:
            seg, nseg = lvl['batch'], G
        x = _stage(p, f'net.down_stage_{l - 1}', pooled, lvl, seg, nseg,
                   m['down_num_blocks'], efs[l], G, m, qdt)
        down[l] = x
    outs = {L: x}
    for i in range(num_up):
        l = L - 1 - i
        lvl = levels[l]
        si = lvl['super_index']
        x_in = torch.cat([down[l], x[si]], 1)
        x = _stage(p, f'net.up_stage_{i}', x_in, lvl, si, levels[l + 1]['n'],
                   m['up_num_blocks'], efs[l], G, m, qdt)
        outs[l] = x
    return [outs[l] @ p[f'head_{l - 1}.classifier.weight'].t()
            + p[f'head_{l - 1}.classifier.bias'] for l in range(1, L + 1)]


# --------------------------------------------------------------------------
# training

def multi_stage_loss(logits, levels, lambdas, num_classes):
    """lambda_1 * cross-entropy of level 1 against each node's dominant
    label (void excluded) + sum over the next levels of lambda_l * the
    cross-entropy against the label histogram, over its whole mass
    (void included)."""
    C = num_classes
    total = 0.0
    for i, lam in enumerate(lambdas):
        z, y = logits[i], levels[i + 1]['y']
        logp = F.log_softmax(z, 1)
        if i == 0:
            t = y.argmax(1)
            valid = t < C
            nll = -logp.gather(1, t.clamp(max=C - 1)[:, None])[:, 0]
            li = (nll * valid).sum() / valid.sum().clamp(min=1)
        else:
            li = -(y[:, :C] * logp).sum() / y.sum().clamp(min=1e-12)
        total = total + lam * li
    return total


def lr_at(o, peak, step):
    """Cosine warm-up from `warmup_init_lr` to `peak` over `num_warmup`
    steps, then a cosine anneal to `eta_min` over `total_steps`."""
    w, lo, end = o['num_warmup'], o['warmup_init_lr'], o['eta_min']
    if step < w:
        return lo + (peak - lo) * 0.5 * (1 - math.cos(math.pi * step / w))
    t = min(max((step - w) / max(o['total_steps'] - w, 1), 0.0), 1.0)
    return end + (peak - end) * 0.5 * (1 + math.cos(math.pi * t))


@torch.no_grad()
def adamw_step(o, p, g, state, step):
    """One AdamW update (decoupled weight decay) of every parameter in
    place, at the schedule's LR of `step` (0-based); the attention
    parameters at `transformer_lr_scale` times it."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, o['weight_decay']
    t = step + 1
    for name, w in p.items():
        peak = o['lr'] * (o['transformer_lr_scale']
                          if is_transformer_param(name) else 1.0)
        lr = lr_at(o, peak, step)
        m, v = state.setdefault(name, (torch.zeros_like(w),
                                       torch.zeros_like(w)))
        m.mul_(b1).add_(g[name], alpha=1 - b1)
        v.mul_(b2).addcmul_(g[name], g[name], value=1 - b2)
        w.mul_(1 - lr * wd)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        w.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(m, o, weights, batches, G, qdtype=None):
    """`len(batches)` training steps from `weights` (name -> tensor, left
    untouched) on level lists of `levels_from_host(..., train=True)`:
    (the loss of each step, before its update; the gradients of the first
    step; the parameters after the last update)."""
    p = {k: v.detach().clone().float() for k, v in weights.items()}
    state, losses, first = {}, [], None
    for s, levels in enumerate(batches):
        leaf = {k: v.requires_grad_(True) for k, v in p.items()}
        logits = forward(m, leaf, levels, G, qdtype)
        loss = multi_stage_loss(logits, levels, o['lambdas'],
                                m['num_classes'])
        grads = torch.autograd.grad(loss, list(leaf.values()),
                                    allow_unused=True)
        g = {k: (torch.zeros_like(v) if d is None else d)
             for (k, v), d in zip(leaf.items(), grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: d.detach().clone() for k, d in g.items()}
        p = {k: v.detach() for k, v in p.items()}
        adamw_step(o, p, g, state, s)
        del logits, loss, grads, g, leaf
    return losses, first, p


# --------------------------------------------------------------------------
# operations

def flops_forward(m, sizes):
    """Model FLOPs of one forward: 2*M*N*K for each contraction (the
    Linear layers, the attention's logits and weighted sums), none for
    element-wise work, at the valid sizes `sizes`: a list over levels
    0..L of (valid nodes, valid neighbor slots)."""
    point, down_in, up_in, edge, heads = _widths(m)
    H, D, R, nc = m['num_heads'], m['qk_dim'], m['h_edge_mlp_out'], \
        m['num_classes']

    def mlp(n, dims):
        return sum(2 * n * a * b for a, b in zip(dims[:-1], dims[1:]))

    def block(n, e, C):
        DH = H * D
        return (2 * n * C * (2 * DH + C) + 2 * e * R * (2 * DH + C)
                + 2 * e * DH + 2 * e * C + 2 * n * C * C)

    L = len(sizes) - 1
    total = mlp(sizes[0][0], point)
    for l in range(1, L + 1):
        n, e = sizes[l]
        total += mlp(e, edge) + mlp(n, down_in[l - 1])
        total += m['down_num_blocks'] * block(n, e, down_in[l - 1][-1])
    for i, dims in enumerate(up_in):
        n, e = sizes[L - 1 - i]
        total += mlp(n, dims) + m['up_num_blocks'] * block(n, e, dims[-1])
    for l in range(1, L + 1):
        total += 2 * sizes[l][0] * heads[l - 1] * nc
    return total

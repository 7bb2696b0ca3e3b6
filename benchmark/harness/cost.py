"""The yardstick's arithmetic: the bytes and FLOPs of one call of the
attention kernels at the valid sizes of a launch, the least time the card
could take for it, the attention launches of a forward, and the model
FLOPs of a batch.

`kernel_cost` is a copy of the program's `ops/cost.py:kernel_cost`
counted at the valid nodes and valid neighbor slots of a launch instead
of its padded `N * K` slots, so that padding that a program change
removes shows as a gain. With every slot valid the two agree.
"""
import json
import os

from ..reference.spt import flops_forward

__all__ = ['kernel_cost', 'bound_s', 'peaks', 'attention_launches',
           'kernel_bound_s', 'batch_flops']

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'peaks.json')


def kernel_cost(name, nodes, slots, H, D, C, De=0, elem=2):
    """(bytes, product FLOPs, other FLOPs) of one call of kernel `name`
    ('K1' or 'K2'; K3 runs on no configured path) over `nodes` valid
    nodes and `slots` valid neighbor slots, H heads of qk_dim D, C value
    channels, De edge features, `elem`-byte inputs. K1 reads a query a
    neighbor slot, as the flagship calls it. Bytes count each input read
    once and each output written once; product FLOPs are the RPE
    projections over the De edge features (tensor cores, bf16); other
    FLOPs are the element-wise, logit and weighted-sum work (f32)."""
    N, DH, W = nodes, H * D, 2 * H * D + C
    if name == 'K1':
        nbytes = slots * (2 * DH + C) * elem + slots + N * 4 + N * C * 4
        return nbytes, 0, slots * (3 * DH + 2 * C)
    inputs = (N * DH + slots * (DH + C + De) + (De + 1) * W) * elem \
        + slots + N * 4
    if name == 'K2':
        return (inputs + N * C * 4, slots * 2 * De * W,
                slots * (W + 2 * DH + 2 * C))
    raise ValueError(name)


def peaks(kind):
    """The published peaks of the card named `kind`
    (`torch.cuda.get_device_name()`), or None for a card not in the
    table."""
    with open(_PEAKS) as f:
        return json.load(f).get(kind)


def bound_s(cost, peak):
    """The least time for a call of cost (bytes, product FLOPs, other
    FLOPs): the larger of its bytes over the memory rate and its FLOPs
    over the peak rates of their types."""
    nbytes, prod, other = cost
    return max(nbytes / peak['bytes_s'],
               prod / peak['bf16_flop_s'] + other / peak['f32_flop_s'])


def attention_launches(m, sizes):
    """[(valid nodes, valid slots, channels)] of each attention call of a
    forward of model section `m` on a batch of valid sizes `sizes`
    (levels 0..L): the down stages' blocks, then the up stages'."""
    L = len(sizes) - 1
    out = []
    for l, d in zip(range(1, L + 1), m['down_dim']):
        out += [sizes[l] + (d,)] * m['down_num_blocks']
    for i, d in enumerate(m['up_dim']):
        out += [sizes[L - 1 - i] + (d,)] * m['up_num_blocks']
    return out


def kernel_bound_s(kernel, m, sizes, peak):
    """The summed least time of the attention launches of one forward, as
    kernel `kernel` ('K1' or 'K2') at the model's widths, bf16 inputs."""
    H, D, De = m['num_heads'], m['qk_dim'], m['h_edge_mlp_out']
    return sum(bound_s(kernel_cost(kernel, n, e, H, D, C, De=De, elem=2),
                       peak)
               for n, e, C in attention_launches(m, sizes))


def batch_flops(m, sizes, train):
    """Model FLOPs of one request (a forward) or one training step (a
    forward and its backward, 3x the forward by the usual convention) on
    a batch of valid sizes `sizes`."""
    return flops_forward(m, sizes) * (3 if train else 1)

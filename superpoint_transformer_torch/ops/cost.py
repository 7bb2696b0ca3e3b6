"""The cost model of the attention kernels K1, K2 and K3: the bytes and
FLOPs of one call at given shapes.

`kernel_cost` is what a call must move and compute at the least (each
input read once, each output written once; product FLOPs that the
tensor cores can take, other FLOPs in f32), from which a roofline bound
follows. `contraction_flops` counts the same call by the model-FLOPs
convention of `utils/flops.py` (the JAX package's `utils/flops.py`:
2*M*N*K per contraction, element-wise work not counted), so that a
kernel and its plain version add the same count.

Shapes: N nodes, K neighbor slots, H heads of qk_dim D, C value
channels, De edge-feature channels.
"""

__all__ = ['kernel_cost', 'contraction_flops']


def kernel_cost(name, N, K, H, D, C, De=0, elem=2, q_per_edge=True):
    """(bytes, product FLOPs, other FLOPs) of one call of kernel `name`
    ('K1', 'K2' or 'K3') at these shapes, with `elem`-byte inputs. Bytes
    count each input read once and each output written once. Product
    FLOPs are the contractions over the De edge features (the RPE
    projections and their gradients), which the tensor cores can take in
    bf16; other FLOPs are the elementwise, logit and weighted-sum work in
    f32. K2 is counted without lse, K3 with the `delta` pass outside."""
    DH, W, slots = H * D, 2 * H * D + C, N * K
    if name == 'K1':
        q = slots * DH if q_per_edge else N * DH
        nbytes = (q + slots * (DH + C)) * elem + slots + N * 4 + N * C * 4
        # q * scale, the logit products and sums, the weighted sum
        return nbytes, 0, slots * (3 * DH + 2 * C)
    # q, the gathered k/v rows and edge features, the weights, mask, scale
    inputs = (N * DH + slots * (DH + C + De) + (De + 1) * W) * elem \
        + slots + N * 4
    if name == 'K2':
        # + out; one projection, the RPE adds, logits, weighted sum
        return (inputs + N * C * 4, slots * 2 * De * W,
                slots * (W + 2 * DH + 2 * C))
    if name == 'K3':
        # + out, lse and g in f32; dq, dkg, dvg, d_ef and the f32 weight
        # gradients out; the projection again, d_ef and the weight
        # gradients, then the RPE adds, logits, dv, dp, dq and dk
        nbytes = inputs + (2 * N * C + H * N) * 4 \
            + (N * DH + slots * (DH + C + De)) * elem + (De + 1) * W * 4
        return (nbytes, slots * 3 * 2 * De * W,
                slots * (W + 5 * DH + 3 * C))
    raise ValueError(name)


def contraction_flops(name, N, K, H, D, C, De=0):
    """Contraction FLOPs of one call of `name` by the model-FLOPs
    convention: 'K1' is the logits <q, k> over D (a query per node or per
    edge alike) and the weighted sum of the values, 2*N*K*(H*D + C); 'K2'
    adds the RPE projections of the De edge features onto k, q and v,
    2*N*K*De*(2*H*D + C); 'K1_bwd' and 'K3' (the backwards of K1 and K2)
    are twice their forwards, as reverse-mode autodiff of those
    contractions counts them."""
    attn = 2 * N * K * (H * D + C)
    if name == 'K1':
        return attn
    if name == 'K1_bwd':
        return 2 * attn
    rpe = 2 * N * K * De * (2 * H * D + C)
    if name == 'K2':
        return rpe + attn
    if name == 'K3':
        return 2 * (rpe + attn)
    raise ValueError(name)

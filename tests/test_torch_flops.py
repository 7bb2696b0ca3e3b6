"""The port's model-FLOP count (`utils/flops.py:matmul_flops`) against the
JAX package's (`utils/flops.py:matmul_flops`, which walks the jaxpr of a
forward that takes the XLA attention on the CPU), and its invariance to
the attention route: a model counts the same through its kernels' entry
points or through `plain_attention`, in evaluation and in a training step
(forward and backward), and each kernel call adds
`ops/cost.py:contraction_flops` at its shapes."""
import pytest
import torch

import jax

from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.utils.flops import (
    matmul_flops as jax_matmul_flops)
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel, SemanticTask)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.ops import attention as tk1
from superpoint_transformer_torch.ops import attention_rpe as tk2
from superpoint_transformer_torch.ops.cost import contraction_flops
from superpoint_transformer_torch.utils.flops import matmul_flops
from test_torch_point_cnn import INTO, NARROW as CNN_NARROW
from test_torch_point_cnn import batches  # noqa: F401
from test_torch_variants import BASE, MODELS, _model_batch, batch  # noqa

CASES = {'narrow': (lambda: dict(BASE), 'variants'),
         'point_cnn': (lambda: dict(CNN_NARROW, **INTO[True]), 'cnn'),
         'B': (lambda: dict(BASE, **MODELS['B']), 'variants')}


def _batch(name, batch, batches):
    if CASES[name][1] == 'cnn':
        return batches[0], batches[1]
    b = _model_batch(batch, name) if name in MODELS else batch
    return b, b


def _port(net, **kw):
    return TModel(TSPT(**net, node_hf_dim=4, v_edge_dim=4, point_hf_dim=8,
                       **kw), 13)


def _jax_materialization(model):
    """What the JAX count holds beyond the model's work: an attention
    block with independent k/q/v RPE calls its three RPE Dense layers on
    a zero [1, De] row to materialize their parameters before it
    concatenates them, 2 * De * (2*H*D + C) FLOPs in the jaxpr."""
    total = 0
    for m in model.modules():
        if getattr(m, 'independent_rpe', False) and hasattr(m, 'v_rpe'):
            width = sum(getattr(m, n).out_features
                        for n in ('k_rpe', 'q_rpe', 'v_rpe'))
            total += 2 * m.k_rpe.in_features * width
    return total


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_count_equals_jax(batch, batches, name):  # noqa: F811
    """The narrow SPT's evaluation forward, with and without the point
    CNN, and the variant SPT B (attentive pool, no edge features): the
    same contraction FLOPs as the JAX count, less its parameter
    materialization (`_jax_materialization`)."""
    jb, tb = _batch(name, batch, batches)
    net = CASES[name][0]()
    jm = JModel(net=JSPT(**net), num_classes=13)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                       train=False))
    ref = jax_matmul_flops(lambda vv, b: jm.apply(vv, b, train=False), v, jb)
    model = _port(net).eval()
    with torch.no_grad():
        got = matmul_flops(model, from_numpy(tb, 'cpu'))
    assert got == ref - _jax_materialization(model) > 0


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', ['narrow', 'B'])
def test_count_is_the_same_with_the_plain_attention(batch, name, train):
    """With the kernels' entry points (K2 in evaluation, K1 in training)
    and with `plain_attention` (autograd through the plain versions), one
    forward, or one training loss and its backward, counts the same."""
    b = from_numpy(_model_batch(batch, name) if name in MODELS else batch,
                   'cpu', train=train)
    net = CASES[name][0]()
    counts = []
    for plain in (False, True):
        task = SemanticTask(TSPT(**net, node_hf_dim=4, v_edge_dim=4,
                                 plain_attention=plain), num_classes=13)
        task.model.train(train)

        def run():
            if train:
                task.loss(b)[0].backward()
            else:
                # under inference_mode the composite ops reach the
                # counter whole
                with torch.inference_mode():
                    task.model(b)

        counts.append(matmul_flops(run))
    assert counts[0] == counts[1] > 0


def test_kernel_calls_add_their_contractions():
    """A call of K1 (a query per node and per edge), K2 and K3 adds its
    `contraction_flops`, and nothing of its plain version's own
    products; K1's backward twice its forward."""
    g = torch.Generator().manual_seed(0)
    N, K, H, D, CH, De = 6, 5, 2, 4, 3, 7
    C = H * CH

    def r(*s):
        return torch.randn(*s, generator=g)

    k, v = r(N, K, H, D), r(N, K, H, CH)
    mask, scale = torch.rand(N, K, generator=g) < 0.7, r(N).abs()
    for q in (r(N, H, D), r(N, K, H, D)):
        assert matmul_flops(tk1.dense_attention, q, k, v, mask, scale) \
            == contraction_flops('K1', N, K, H, D, C)
        # forward and backward (q, k, v take gradients, as in a model),
        # through K1's entry point and through its plain version
        for fn in (tk1.dense_attention_trainable,
                   tk1.dense_attention_reference):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            got = matmul_flops(lambda: fn(*qkv, mask, scale).sum()
                               .backward())
            assert got == 3 * contraction_flops('K1', N, K, H, D, C)
    args = (r(N, H, D), r(N, K, H * D), r(N, K, C), r(N, K, De),
            r(De, H * D), r(H * D), r(De, H * D), r(H * D), r(De, C), r(C),
            mask, scale)
    k2 = contraction_flops('K2', N, K, H, D, C, De)
    assert matmul_flops(tk2.dense_attention_rpe, *args) == k2
    assert matmul_flops(tk2.dense_attention_rpe_reference, *args) == k2
    out, lse = tk2.dense_attention_rpe(*args, with_lse=True)
    assert matmul_flops(tk2.dense_attention_rpe_bwd, *args, out, lse,
                        r(N, H, CH)) == contraction_flops('K3', N, K, H, D,
                                                          C, De) == 2 * k2


def test_counting_changes_nothing(batch):
    """Outside `matmul_flops` the hooks are no-ops, and under it the model
    computes the same values."""
    b = from_numpy(batch, 'cpu', train=True)
    model = _port(BASE).train()
    out = model(b)[0]
    assert out.grad_fn is not None
    again = []
    matmul_flops(lambda: again.append(model(b)[0]))
    assert torch.equal(out, again[0])

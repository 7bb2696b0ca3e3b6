"""Faults planted in the program underneath a run, to show that the
check that decides `correct` catches them (`calibrate.py` reads them on
the card at a cell's own size; `tests/test_bench_control.py` on the CPU
at a small one). Never used by `run.py`.

- `unchanged`: the optimizer's step returns the state unchanged;
- `half_batch`: the graphs of the second half of every batch are left
  out (their rows masked), so norms and the loss take the mean over the
  rest;
- `altered_answer`: a served answer altered where it is produced: one
  request in five gets its level-1 logits turned upside down, so that
  each node's class is the one the model ranks last;
- `altered_graph`: the same, for the nodes of one graph (tile or room)
  of the request only;
- `moved_double`: in training, one parameter moved twice as far as the
  step moves it;
- `subset_dropped`: in training, a backward fault confined to a subset
  of the leaves: the gradients of the relative-position projections and
  the edge MLPs (58 of the flagship's 147 leaves) are lost (zero).

`FAULTS` lists the faults that each cell's check has to fail. Two more
can be planted and read (`calibrate.py --only`), which no number of the
check separates from sound runs on every seed (PERF.md has their
readings):

- `subset_grad`: the gradients of the same subset come out twice too
  large (AdamW's update does not change with a leaf's gradient scale);
- `k1_dk_scaled`: K1's backward returns its key gradient doubled.
"""
from contextlib import contextmanager

__all__ = ['FAULTS', 'plant']

FAULTS = {'train': ('unchanged', 'half_batch', 'moved_double',
                    'subset_dropped'),
          'serve': ('half_batch', 'altered_answer', 'altered_graph')}
SUBSET = ('rpe', 'edge_mlp')


def _half(batch):
    G = int(batch.num_graphs)
    for lvl in batch.levels:
        lvl.node_mask = lvl.node_mask & (lvl.batch < G // 2)
    return batch


@contextmanager
def plant(name):
    import torch
    from superpoint_transformer_torch.data import padded
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel as Model, SemanticTask)
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == 'unchanged':
        patch(torch.optim.AdamW, 'step', lambda self, closure=None: None)
    elif name == 'half_batch':
        orig = padded.from_numpy
        patch(padded, 'from_numpy', lambda *a, **k: _half(orig(*a, **k)))
    elif name == 'altered_answer':
        forward, calls = Model.forward, [0]

        def forward_altered(self, nag):
            out = forward(self, nag)
            calls[0] += 1
            if calls[0] % 5 == 0:
                out[0] = -out[0]
            return out

        patch(Model, 'forward', forward_altered)
    elif name == 'altered_graph':
        forward, calls = Model.forward, [0]

        def forward_altered(self, nag):
            out = forward(self, nag)
            calls[0] += 1
            if calls[0] % 5 == 0:
                one = (nag[1].batch == 0)[:, None]
                out[0] = torch.where(one, -out[0], out[0])
            return out

        patch(Model, 'forward', forward_altered)
    elif name in ('subset_grad', 'subset_dropped'):
        train_step, scale = SemanticTask.train_step, (
            2.0 if name == 'subset_grad' else 0.0)

        def step_altered(self, *args, **kwargs):
            if not getattr(self, '_bench_fault', False):
                for n, p in self.model.named_parameters():
                    if any(s in n for s in SUBSET):
                        p.register_hook(lambda g: g * scale)
                self._bench_fault = True
            return train_step(self, *args, **kwargs)

        patch(SemanticTask, 'train_step', step_altered)
    elif name == 'k1_dk_scaled':
        from superpoint_transformer_torch.ops import attention
        bwd = attention.dense_attention_bwd

        def bwd_altered(*args, **kwargs):
            dq, dk, dv, dscale = bwd(*args, **kwargs)
            return dq, 2 * dk, dv, dscale

        patch(attention, 'dense_attention_bwd', bwd_altered)
    elif name == 'moved_double':
        step = torch.optim.AdamW.step

        def step_altered(self, closure=None):
            p = self.param_groups[0]['params'][0]
            before = p.detach().clone()
            out = step(self, closure)
            with torch.no_grad():
                p.add_(p - before)
            return out

        patch(torch.optim.AdamW, 'step', step_altered)
    else:
        raise ValueError(f'unknown fault {name!r}')
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)

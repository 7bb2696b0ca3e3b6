"""Faults planted in the panoptic program underneath a run, to show that
the check of a panoptic serving cell (`harness/panoptic_check.py`)
catches them (`calibrate_panoptic.py` reads them on the card at the
cell's own size; `tests/test_bench_panoptic.py` on the CPU at a small
one). Never used by `run.py`.

- `shifted_affinity`: the edge-affinity logits come out shifted by one
  edge (edge e gets edge e-1's), so the partition cuts by another edge's
  affinity;
- `other_graph`: each request is served with the level-1 instance graph
  of the request before it (its edges between rows that the batch has);
- `stuff_skipped`: the instances of the stuff classes are not merged;
- `unweighted_nodes`: the partition takes every superpoint's weight as
  1, not its size, so it solves another energy.

`register` hands these faults and the kind's control to the generic
ones of `faults.py` and `calibrate.py`, which know the `serve` and
`train` kinds, so that `tests/test_bench_control.py` reads the panoptic
cell's control and faults as it reads every other cell's
(`benchmark/conftest.py` calls it before the tests are collected).
"""
import copy
from contextlib import contextmanager

import numpy as np

__all__ = ['FAULTS', 'KIND', 'plant', 'register']

KIND = 'panoptic_serve'
FAULTS = ('shifted_affinity', 'other_graph', 'stuff_skipped',
          'unweighted_nodes')


def _with_graph(batch, host, edges):
    """`batch` (on its device) and a copy of `host` whose level-1
    instance graph is `edges` [2, E], padded to the host's capacity."""
    import torch
    lvl = host.levels[1]
    cap = lvl.obj_edge_index.shape[1]
    e = edges[:, :cap]
    oei = np.zeros((2, cap), np.int32)
    oei[:, :e.shape[1]] = e
    oem = np.zeros(cap, bool)
    oem[:e.shape[1]] = True
    host = copy.copy(host)
    lvl = copy.copy(lvl)
    lvl.obj_edge_index, lvl.obj_edge_mask = oei, oem
    host.levels = tuple(lvl if i == 1 else l
                        for i, l in enumerate(host.levels))
    dev = batch[1].obj_edge_index.device
    batch[1].obj_edge_index = torch.as_tensor(oei, device=dev).long()
    batch[1].obj_edge_mask = torch.as_tensor(oem, device=dev)
    return batch, host


@contextmanager
def plant(name):
    from superpoint_transformer_torch import inference
    from superpoint_transformer_torch.models import panoptic
    from superpoint_transformer_torch.models.panoptic import (
        PanopticSegmentationModel as Model)
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    infer = inference.infer_panoptic_batch
    if name == 'shifted_affinity':
        import torch
        forward = Model.forward

        def forward_shifted(self, nag):
            logits, ea = forward(self, nag)
            return logits, None if ea is None else torch.roll(ea, 1)

        patch(Model, 'forward', forward_shifted)
    elif name == 'other_graph':
        last = {}

        def infer_other(task, batch, host, settings):
            lvl = host.levels[1]
            mine = np.asarray(lvl.obj_edge_index)[
                :, np.asarray(lvl.obj_edge_mask, bool)]
            if 'edges' in last:
                n1 = int(lvl.num_nodes)
                e = last['edges']
                batch, host = _with_graph(batch, host,
                                          e[:, (e < n1).all(0)])
            last['edges'] = mine
            return infer(task, batch, host, settings)

        patch(inference, 'infer_panoptic_batch', infer_other)
    elif name == 'stuff_skipped':
        def infer_unmerged(task, batch, host, settings):
            stuff, task.stuff_classes = task.stuff_classes, ()
            try:
                return infer(task, batch, host, settings)
            finally:
                task.stuff_classes = stuff

        patch(inference, 'infer_panoptic_batch', infer_unmerged)
    elif name == 'unweighted_nodes':
        cut = panoptic.greedy_cut

        def cut_unweighted(*args, **kwargs):
            return cut(*args, **dict(kwargs, node_weight=None))

        patch(panoptic, 'greedy_cut', cut_unweighted)
    else:
        raise ValueError(f'unknown fault {name!r}')
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def register():
    """Let `faults.FAULTS`, `faults.plant` and `calibrate.control_numbers`
    take the panoptic serving kind too: its faults from this module, its
    control from `calibrate_panoptic.control_numbers`. Once a process."""
    from benchmark import calibrate, calibrate_panoptic, faults
    if KIND in faults.FAULTS:
        return
    faults.FAULTS[KIND] = FAULTS
    plant_other, control_other = faults.plant, calibrate.control_numbers

    def plant_any(name):
        return (plant if name in FAULTS else plant_other)(name)

    def control_any(cfg, traffic, seed, device):
        control = (calibrate_panoptic.control_numbers
                   if traffic['kind'] == KIND else control_other)
        return control(cfg, traffic, seed, device)

    faults.plant, calibrate.control_numbers = plant_any, control_any

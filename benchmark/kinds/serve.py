"""Serving: one client, closed loop. A request is a padded host batch of
preprocessed tiles; the program moves it to the card (`from_numpy`),
runs the model's forward and the level-1 argmax, and returns the
predictions on the host in the NAG's row order (`infer_batch`). Its
latency runs from the batch in hand to the predictions in hand.

After the window, every answer is read against the plain reference's
float32 logits of its batch (`harness/check.py:serve_numbers`)."""
import numpy as np

from ..harness.check import serve_numbers
from ..harness.common import (Phases, build_kernels, card, closed_loop,
                              free, make_pool)
from ..harness.weights import draw_weights
from ..reference import spt as ref

__all__ = ['run', 'reference_logits', 'node_graphs', 'WARMUP_PASSES']

WARMUP_PASSES = 2


def _program(cfg, traffic, weights, device):
    from superpoint_transformer_torch import experiment
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.inference import infer_batch
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    m = cfg['model']
    net = experiment.build_model(getattr(experiment, cfg['program_config']),
                                 num_graphs=traffic['graphs'], device=device)
    model = SemanticSegmentationModel(net, m['num_classes'], device=device)
    model.load_state_dict(weights)
    model.eval()
    cd = model.net.compute_dtype

    def request(host):
        return infer_batch(model, from_numpy(host, device, cd))
    return model, request


def reference_logits(cfg, host, weights, device, qdtype=None):
    """The reference's level-1 logits of a host batch, in the NAG's row
    order, as float32 numpy."""
    import torch
    with torch.no_grad():
        levels = ref.levels_from_host(host, device)
        z = ref.forward(cfg['model'], weights, levels, int(host.num_graphs),
                        qdtype)[0]
    n1 = int(host.levels[1].num_nodes)
    nid = np.asarray(host.levels[1].node_id[:n1])
    out = np.empty((n1, z.shape[1]), np.float32)
    out[nid] = z.float().cpu().numpy()
    return out


def node_graphs(host):
    """The graph of each level-1 node of a host batch, in the NAG's row
    order."""
    n1 = int(host.levels[1].num_nodes)
    out = np.empty(n1, np.int64)
    out[np.asarray(host.levels[1].node_id[:n1])] = host.levels[1].batch[:n1]
    return out


def run(cfg, traffic, seed, seconds, trace, device, setup_clock):
    import torch
    device = torch.device(device)
    phases = Phases(setup_clock)
    if device.type == 'cuda':
        torch.empty(1, device=device)
    phases.mark('context')
    build_kernels(device)
    phases.mark('kernels')
    weights = draw_weights(cfg['model'], seed, device)
    model, request = _program(cfg, traffic, weights, device)
    phases.mark('program')
    pool, sizes = make_pool(cfg, traffic, seed, train=False)
    phases.mark('pool')
    for _ in range(WARMUP_PASSES):
        for host in pool:
            request(host)
    answers = []
    phases.mark('warmup')
    setup_s = setup_clock()
    window, order, times, tr, stretch = closed_loop(
        lambda i: request(pool[i]), len(pool), seconds, device,
        trace_steps=traffic['trace_steps'] if trace else None,
        on_done=lambda k, out: answers.append(out))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    platform, name, limit = card(device)
    del model, request
    free(device)

    # the reference, once a distinct batch, after the program is freed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logits = {b: reference_logits(cfg, pool[b], weights, device)
              for b in sorted(set(order))}
    graphs = {b: node_graphs(pool[b]) for b in logits}
    numbers, bad = serve_numbers(logits, graphs, list(zip(order, answers)))
    points = [sizes[i][0][0] for i in order]
    return {'platform': platform, 'kind_name': name, 'power_limit': limit,
            'memory_peak_bytes': peak, 'attempted': len(order),
            'failed': bad, 'numbers': numbers, 'setup_s': setup_s,
            'window_s': window, 'order': order, 'points': points,
            'latencies_s': [b - a for a, b in times], 'trace': tr,
            'stretch': stretch, 'sizes': sizes, 'model': cfg['model'],
            'train': False, 'seed': seed,
            'setup_split': phases.split()}

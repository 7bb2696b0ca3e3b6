"""Panoptic serving (SuperCluster): one client, closed loop. A request is
a padded host batch of preprocessed tiles with its level-1 instance
graph (`harness/instance_traffic.py`); the program moves it to the card
(`from_numpy`), runs the backbone, the heads and the edge-affinity head,
fetches the level-1 logits and the edge affinities, partitions level 1
into instances on the host and classes each instance
(`inference.infer_panoptic_batch`). Its latency runs from the host batch
in hand to the instance ids and classes in hand.

After the window, every answer is read against the plain reference's
panoptic answer of its batch (`harness/panoptic_check.py`)."""
from ..harness.common import Phases, build_kernels, card, closed_loop, free
from ..harness.instance_traffic import make_panoptic_pool
from ..harness.panoptic_check import panoptic_numbers
from ..harness.panoptic_weights import draw_panoptic_weights
from ..reference import panoptic as ref

__all__ = ['run', 'settings_of', 'WARMUP_PASSES']

WARMUP_PASSES = 2


def settings_of(cfg):
    """The partition's settings and the stuff classes of a configuration
    file."""
    p = cfg['model']['partitioner']
    return ({'regularization': float(p['regularization']),
             'x_weight': float(p['x_weight']),
             'cutoff': float(p['cutoff'])},
            tuple(int(c) for c in cfg['model']['stuff_classes']))


def _entry_points(cfg):
    """The program's configuration and entry points; raises at once on a
    program without them, before any set-up."""
    from superpoint_transformer_torch import experiment
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.inference import infer_panoptic_batch
    return (experiment, getattr(experiment, cfg['program_config']),
            from_numpy, infer_panoptic_batch)


def _program(cfg, traffic, weights, device):
    experiment, pcfg, from_numpy, infer_panoptic_batch = _entry_points(cfg)
    task = experiment.build_task(pcfg, num_graphs=traffic['graphs'],
                                 device=device)
    model = task.model
    model.load_state_dict(weights)
    model.eval()
    cd = model.net.compute_dtype
    settings = experiment.partition_settings(pcfg)

    def request(host):
        return infer_panoptic_batch(task, from_numpy(host, device, cd),
                                    host, settings)
    return task, request


def run(cfg, traffic, seed, seconds, trace, device, setup_clock):
    import torch
    _entry_points(cfg)
    device = torch.device(device)
    phases = Phases(setup_clock)
    if device.type == 'cuda':
        torch.empty(1, device=device)
    phases.mark('context')
    build_kernels(device)
    phases.mark('kernels')
    weights = draw_panoptic_weights(cfg['model'], seed, device)
    task, request = _program(cfg, traffic, weights, device)
    phases.mark('program')
    pool, sizes = make_panoptic_pool(cfg, traffic, seed)
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
    del task, request
    free(device)

    # the reference, once a distinct batch, after the program is freed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings, stuff = settings_of(cfg)
    refs = {b: ref.answer(cfg['model'], weights, pool[b], settings, stuff,
                          device) for b in sorted(set(order))}
    numbers, bad = panoptic_numbers(refs, list(zip(order, answers)),
                                    settings, stuff)
    points = [sizes[i][0][0] for i in order]
    return {'platform': platform, 'kind_name': name, 'power_limit': limit,
            'memory_peak_bytes': peak, 'attempted': len(order),
            'failed': bad, 'numbers': numbers, 'setup_s': setup_s,
            'window_s': window, 'order': order, 'points': points,
            'latencies_s': [b - a for a, b in times], 'trace': tr,
            'stretch': stretch, 'sizes': sizes, 'model': cfg['model'],
            'train': False, 'seed': seed,
            'setup_split': phases.split()}

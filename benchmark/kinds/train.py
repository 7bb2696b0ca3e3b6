"""Training: one training task (model, AdamW state, schedule) built once
and driven from the seed. A step moves a padded host batch to the card
(`from_numpy(train=True)` from pinned memory, as the Trainer does) and
runs `SemanticTask.train_step` (forward, backward, AdamW update); steps
follow one another with no host synchronize between them.

Set-up drives the task through its first steps, on distinct batches of
the pool, through the same call as the window, and keeps what the check
reads: each of the first three steps' loss, AdamW's first moment after
step 1 (its first gradient times 1 - beta1), and the parameters before
step 4. The window then continues with the same task. After the window
the plain reference takes the same three steps from the same weights
(`harness/check.py:train_numbers`)."""
from ..harness.check import train_numbers
from ..harness.common import (Phases, build_kernels, card, closed_loop,
                              free, make_pool)
from ..harness.weights import draw_weights
from ..reference import spt as ref

__all__ = ['run', 'reference_steps', 'CHECKED_STEPS', 'WARMUP_PASSES']

CHECKED_STEPS = 3
WARMUP_PASSES = 2
BETA1 = 0.9


def _program(cfg, traffic, weights, device):
    from superpoint_transformer_torch import experiment
    from superpoint_transformer_torch.data.padded import from_numpy
    o = cfg['optim']
    task = experiment.build_task(
        getattr(experiment, cfg['program_config']),
        num_graphs=traffic['graphs'], total_steps=o['total_steps'],
        device=device)
    task.model.load_state_dict(weights)
    cd = task.model.net.compute_dtype

    def step(host):
        return task.train_step(from_numpy(host, device, cd, train=True,
                                          pin_memory=True))
    return task, step


def reference_steps(cfg, pool, weights, device, qdtype=None):
    """(losses, first gradients, changes after the last step) of the
    reference's first steps on `pool`'s first batches."""
    levels = [ref.levels_from_host(b, device, train=True)
              for b in pool[:CHECKED_STEPS]]
    losses, grads, after = ref.train_steps(
        cfg['model'], cfg['optim'], weights, levels,
        int(pool[0].num_graphs), qdtype)
    return losses, grads, {k: after[k] - weights[k] for k in weights}


def run(cfg, traffic, seed, seconds, trace, device, setup_clock):
    import torch
    device = torch.device(device)
    if traffic['pool'] < CHECKED_STEPS:
        raise ValueError('train: the pool needs a distinct batch for each '
                         f'of the first {CHECKED_STEPS} steps')
    phases = Phases(setup_clock)
    if device.type == 'cuda':
        torch.empty(1, device=device)
    phases.mark('context')
    build_kernels(device)
    phases.mark('kernels')
    weights = draw_weights(cfg['model'], seed, device)
    task, step = _program(cfg, traffic, weights, device)
    phases.mark('program')
    pool, sizes = make_pool(cfg, traffic, seed, train=True)
    phases.mark('pool')
    params = dict(task.model.named_parameters())

    # the first steps, which the reference follows, then the warm-up
    losses, grads = [], None
    for k in range(WARMUP_PASSES * len(pool)):
        out = step(pool[k % len(pool)])
        if k < CHECKED_STEPS:
            losses.append(out['loss'])
        if k == 0:
            state = task.optimizer.state
            grads = {n: state[p]['exp_avg'].detach() / (1 - BETA1)
                     if 'exp_avg' in state.get(p, {})
                     else torch.zeros_like(p) for n, p in params.items()}
        if k == CHECKED_STEPS - 1:
            deltas = {n: p.detach() - weights[n] for n, p in params.items()}
    losses = [float(x) for x in losses]
    last = {}
    phases.mark('warmup')
    setup_s = setup_clock()
    window, order, _, tr, stretch = closed_loop(
        lambda i: step(pool[i]), len(pool), seconds, device,
        trace_steps=traffic['trace_steps'] if trace else None,
        on_done=lambda k, out: last.__setitem__('loss', out['loss']))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    platform, name, limit = card(device)
    final_loss = float(last['loss']) if last else float('nan')
    del task, step, params, last
    free(device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = train_numbers(losses, grads, deltas,
                            *reference_steps(cfg, pool, weights, device))
    points = [sizes[i][0][0] for i in order]
    return {'platform': platform, 'kind_name': name, 'power_limit': limit,
            'memory_peak_bytes': peak, 'attempted': len(order),
            'failed': 0, 'numbers': numbers, 'setup_s': setup_s,
            'window_s': window, 'order': order, 'points': points,
            'latencies_s': None, 'trace': tr, 'stretch': stretch,
            'sizes': sizes, 'model': cfg['model'], 'train': True,
            'seed': seed, 'losses': losses, 'final_loss': final_loss,
            'setup_split': phases.split()}

"""AdamW with cosine warm-up and a scaled learning rate on the attention
parameters; counterpart of `cosine_with_warmup`, `_is_transformer_param`
and `make_optimizer` in `superpoint_transformer_tpu/optim/lr_scheduler.py`.

`torch.optim.AdamW` is optax's `adamw` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay on every parameter). The two parameter groups
have schedules that are not proportional (both start and end at 1e-6),
so each group carries its own schedule, and `set_lr` writes the LR of
step `s` into every group before the update of step `s` (optax's first
update uses step 0).
"""
import math

import torch

__all__ = ['cosine_with_warmup', 'is_transformer_param', 'make_optimizer',
           'set_lr']


def cosine_with_warmup(lr, total_steps, num_warmup_steps,
                       warmup_init_lr=1e-6, eta_min=1e-6,
                       warmup_strategy='cos'):
    """The LR at a step: warm-up from `warmup_init_lr` to `lr` over
    `num_warmup_steps` ('cos' or 'linear' shape), then a cosine anneal to
    `eta_min` over the remaining steps."""
    if warmup_strategy not in ('cos', 'linear'):
        raise ValueError(f'unknown warmup_strategy {warmup_strategy!r}')

    def schedule(step):
        w = float(num_warmup_steps)
        frac = min(max(step / max(w, 1.0), 0.0), 1.0)
        if step < w:
            if warmup_strategy == 'cos':
                frac = 0.5 * (1 - math.cos(math.pi * frac))
            return warmup_init_lr + (lr - warmup_init_lr) * frac
        progress = min(max((step - w) / max(total_steps - w, 1.0), 0.0),
                       1.0)
        return eta_min + (lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * progress))

    return schedule


def is_transformer_param(name):
    """Attention and attentive-pool parameters get the scaled LR: the
    JAX rule on a `state_dict` name (`net.down_stage_0.block_1.sa.qkv.
    weight`: under a `block_*` and its `sa`, or a `down_pool_block`)."""
    joined = name.replace('.', '/')
    return ('block_' in joined and ('/sa/' in joined + '/'
                                    or joined.endswith('/sa'))) \
        or 'down_pool_block' in joined


def make_optimizer(module, lr=0.01, weight_decay=1e-4,
                   transformer_lr_scale=0.1, total_steps=100_000,
                   num_warmup_steps=2_000, warmup_init_lr=1e-6,
                   eta_min=1e-6):
    """AdamW over `module`'s parameters in two groups, 'base' and
    'transformer' (`is_transformer_param`), the second at
    `transformer_lr_scale * lr`. Returns (optimizer, schedules), one
    schedule per parameter group; empty groups are left out."""
    groups, schedules = [], []
    for label, peak in (('base', lr),
                        ('transformer', lr * transformer_lr_scale)):
        params = [p for n, p in module.named_parameters()
                  if is_transformer_param(n) == (label == 'transformer')]
        if not params:
            continue
        sched = cosine_with_warmup(peak, total_steps, num_warmup_steps,
                                   warmup_init_lr=warmup_init_lr,
                                   eta_min=eta_min)
        groups.append({'params': params, 'name': label, 'lr': sched(0)})
        schedules.append(sched)
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, schedules


def set_lr(optimizer, schedules, step):
    """Write each group's LR at `step`."""
    for group, sched in zip(optimizer.param_groups, schedules):
        group['lr'] = sched(step)

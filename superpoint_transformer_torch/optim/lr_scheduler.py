"""AdamW with cosine warm-up and a scaled learning rate on the attention
parameters, and the plateau variant; counterpart of `cosine_with_warmup`,
`_is_transformer_param`, `make_optimizer`, `warmup_constant`,
`ReduceOnPlateau`, `make_plateau_optimizer` and `set_lr_multiplier` in
`superpoint_transformer_tpu/optim/lr_scheduler.py`, and of its other
schedules (`step_with_warmup`, `multi_step_with_warmup`,
`exponential_with_warmup`, `cosine_power_with_warmup`) and their factory
`make_schedule`, which the JAX package exports and calls nowhere. A
schedule is a plain function of the step (a partial of a module
function, so that a task pickles), in float64 where JAX computes in f32.

`torch.optim.AdamW` is optax's `adamw` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay on every parameter). The two parameter groups
have schedules that are not proportional (both start and end at 1e-6),
so each group carries its own schedule, and `set_lr` writes the LR of
step `s` into every group before the update of step `s` (optax's first
update uses step 0).

The JAX plateau optimizer chains `optax.scale(lr_mult)` after AdamW, which
scales the whole update, decoupled weight decay included. Scaling every
group's LR by the multiplier (`set_lr`'s `multiplier`) is the same update.
"""
import functools
import math

import torch

__all__ = ['cosine_with_warmup', 'is_transformer_param', 'make_optimizer',
           'set_lr', 'warmup_constant', 'ReduceOnPlateau',
           'make_plateau_optimizer', 'set_lr_multiplier', 'step_with_warmup',
           'multi_step_with_warmup', 'exponential_with_warmup',
           'cosine_power_with_warmup', 'make_schedule']


def cosine_with_warmup(lr, total_steps, num_warmup_steps,
                       warmup_init_lr=1e-6, eta_min=1e-6,
                       warmup_strategy='cos'):
    """The LR at a step: warm-up from `warmup_init_lr` to `lr` over
    `num_warmup_steps` ('cos' or 'linear' shape), then a cosine anneal to
    `eta_min` over the remaining steps."""
    if warmup_strategy not in ('cos', 'linear'):
        raise ValueError(f'unknown warmup_strategy {warmup_strategy!r}')
    # a partial of a module function, so that a task pickles (the
    # data-parallel Trainer sends it to its ranks)
    return functools.partial(_cosine_with_warmup, lr, total_steps,
                             num_warmup_steps, warmup_init_lr, eta_min,
                             warmup_strategy)


def _cosine_with_warmup(lr, total_steps, num_warmup_steps, warmup_init_lr,
                        eta_min, warmup_strategy, step):
    w = float(num_warmup_steps)
    frac = min(max(step / max(w, 1.0), 0.0), 1.0)
    if step < w:
        if warmup_strategy == 'cos':
            frac = 0.5 * (1 - math.cos(math.pi * frac))
        return warmup_init_lr + (lr - warmup_init_lr) * frac
    progress = min(max((step - w) / max(total_steps - w, 1.0), 0.0), 1.0)
    return eta_min + (lr - eta_min) * 0.5 * (
        1 + math.cos(math.pi * progress))


def _with_warmup(lr, body, num_warmup_steps, warmup_init_lr, warmup_strategy,
                 step):
    """The warm-up from `warmup_init_lr` to `lr` over `num_warmup_steps`
    ('cos' or 'linear' shape), then `body(step - num_warmup_steps)`."""
    w = float(num_warmup_steps)
    if step < w:
        frac = min(max(step / max(w, 1.0), 0.0), 1.0)
        if warmup_strategy != 'linear':
            frac = 0.5 * (1 - math.cos(math.pi * frac))
        return warmup_init_lr + (lr - warmup_init_lr) * frac
    return body(max(step - w, 0.0))


def _warmup_schedule(body, lr, num_warmup_steps, warmup_init_lr=1e-6,
                     warmup_strategy='cos'):
    return functools.partial(_with_warmup, lr, body, num_warmup_steps,
                             warmup_init_lr, warmup_strategy)


def _step_body(lr, step_size, gamma, s):
    return lr * gamma ** math.floor(s / step_size)


def _multi_step_body(lr, milestones, gamma, s):
    return lr * gamma ** sum(s >= m for m in milestones)


def _exponential_body(lr, gamma, s):
    return lr * gamma ** s


def _cosine_power_body(lr, total_steps, power, eta_min, num_warmup_steps, s):
    t = max(total_steps - num_warmup_steps, 1)
    progress = min(max(s / t, 0.0), 1.0)
    return eta_min + (lr - eta_min) * (
        0.5 * (1 + math.cos(math.pi * progress))) ** power


def step_with_warmup(lr, step_size, gamma=0.1, num_warmup_steps=0, **kw):
    """Warm-up, then `lr` times `gamma` every `step_size` steps."""
    return _warmup_schedule(functools.partial(_step_body, lr, step_size,
                                              gamma),
                            lr, num_warmup_steps, **kw)


def multi_step_with_warmup(lr, milestones, gamma=0.1, num_warmup_steps=0,
                           **kw):
    """Warm-up, then `lr` times `gamma` at each of `milestones` (steps
    after the warm-up) passed."""
    return _warmup_schedule(functools.partial(
        _multi_step_body, lr, tuple(float(m) for m in milestones), gamma),
        lr, num_warmup_steps, **kw)


def exponential_with_warmup(lr, gamma=0.999, num_warmup_steps=0, **kw):
    """Warm-up, then `lr * gamma ** step`."""
    return _warmup_schedule(functools.partial(_exponential_body, lr, gamma),
                            lr, num_warmup_steps, **kw)


def cosine_power_with_warmup(lr, total_steps, power=2.0, eta_min=1e-6,
                             num_warmup_steps=0, **kw):
    """Warm-up, then a cosine anneal to `eta_min` raised to `power` (a
    sharper decay than the cosine's)."""
    return _warmup_schedule(functools.partial(
        _cosine_power_body, lr, total_steps, power, eta_min,
        num_warmup_steps), lr, num_warmup_steps, **kw)


def make_schedule(name, lr, total_steps, num_warmup_steps=0, **kw):
    """The schedule named `name`: None / 'cosine' / 'cos', 'step',
    'multistep', 'exponential' or 'cosine_power'."""
    if name in (None, 'cosine', 'cos'):
        return cosine_with_warmup(lr, total_steps, num_warmup_steps, **kw)
    if name == 'step':
        return step_with_warmup(lr, num_warmup_steps=num_warmup_steps, **kw)
    if name == 'multistep':
        return multi_step_with_warmup(lr, num_warmup_steps=num_warmup_steps,
                                      **kw)
    if name == 'exponential':
        return exponential_with_warmup(
            lr, num_warmup_steps=num_warmup_steps, **kw)
    if name == 'cosine_power':
        return cosine_power_with_warmup(
            lr, total_steps, num_warmup_steps=num_warmup_steps, **kw)
    raise ValueError(f'unknown scheduler {name}')


def is_transformer_param(name):
    """Attention and attentive-pool parameters get the scaled LR: the
    JAX rule on a `state_dict` name (`net.down_stage_0.block_1.sa.qkv.
    weight`: under a `block_*` and its `sa`, or a `down_pool_block`)."""
    joined = name.replace('.', '/')
    return ('block_' in joined and ('/sa/' in joined + '/'
                                    or joined.endswith('/sa'))) \
        or 'down_pool_block' in joined


def warmup_constant(lr, num_warmup_steps=0, warmup_init_lr=1e-6,
                    warmup_strategy='cos'):
    """The LR at a step: warm-up from `warmup_init_lr` to `lr` over
    `num_warmup_steps`, then constant: the base schedule under the
    plateau controller."""
    if warmup_strategy not in ('cos', 'linear'):
        raise ValueError(f'unknown warmup_strategy {warmup_strategy!r}')
    return functools.partial(_warmup_constant, lr, num_warmup_steps,
                             warmup_init_lr, warmup_strategy)


def _warmup_constant(lr, num_warmup_steps, warmup_init_lr, warmup_strategy,
                     step):
    w = float(num_warmup_steps)
    if step < w:
        frac = min(max(step / max(w, 1.0), 0.0), 1.0)
        if warmup_strategy == 'cos':
            frac = 0.5 * (1 - math.cos(math.pi * frac))
        return warmup_init_lr + (lr - warmup_init_lr) * frac
    return lr


def _adamw(module, schedule_of, lr, weight_decay, transformer_lr_scale):
    """AdamW over `module`'s parameters in the 'base' and 'transformer'
    groups, each with `schedule_of(peak)`; empty groups are left out."""
    groups, schedules = [], []
    for label, peak in (('base', lr),
                        ('transformer', lr * transformer_lr_scale)):
        params = [p for n, p in module.named_parameters()
                  if is_transformer_param(n) == (label == 'transformer')]
        if not params:
            continue
        sched = schedule_of(peak)
        groups.append({'params': params, 'name': label, 'lr': sched(0)})
        schedules.append(sched)
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, schedules


def make_optimizer(module, lr=0.01, weight_decay=1e-4,
                   transformer_lr_scale=0.1, total_steps=100_000,
                   num_warmup_steps=2_000, warmup_init_lr=1e-6,
                   eta_min=1e-6):
    """AdamW over `module`'s parameters in two groups, 'base' and
    'transformer' (`is_transformer_param`), the second at
    `transformer_lr_scale * lr`, each on a cosine warm-up. Returns
    (optimizer, schedules), one schedule per parameter group; empty
    groups are left out."""
    return _adamw(module, lambda peak: cosine_with_warmup(
        peak, total_steps, num_warmup_steps, warmup_init_lr=warmup_init_lr,
        eta_min=eta_min), lr, weight_decay, transformer_lr_scale)


def make_plateau_optimizer(module, lr=0.01, weight_decay=1e-4,
                           transformer_lr_scale=0.1,
                           num_warmup_steps=2_000, warmup_init_lr=1e-6):
    """`make_optimizer`'s two AdamW groups on a warm-up then constant
    schedule (`warmup_constant`). The plateau multiplier scales both
    groups' LR through `set_lr` (see `set_lr_multiplier`)."""
    return _adamw(module, lambda peak: warmup_constant(
        peak, num_warmup_steps, warmup_init_lr), lr, weight_decay,
        transformer_lr_scale)


def set_lr(optimizer, schedules, step, multiplier=1.0):
    """Write each group's LR at `step`, times the plateau `multiplier`."""
    for group, sched in zip(optimizer.param_groups, schedules):
        group['lr'] = sched(step) * multiplier


def set_lr_multiplier(task, multiplier):
    """Set the plateau multiplier of `task`: every later update runs at
    its schedule's LR times `multiplier` (the JAX `lr_mult`
    hyperparameter)."""
    task.lr_mult = float(multiplier)
    return task


class ReduceOnPlateau:
    """Host-side plateau controller (torch ReduceLROnPlateau semantics,
    as the JAX package's). Call `step(metric)` once per validation; read
    `multiplier` and push it into the task with `set_lr_multiplier`."""

    def __init__(self, mode='max', factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode='rel', cooldown=0,
                 min_mult=1e-8):
        if mode not in ('min', 'max'):
            raise ValueError(f'unknown mode {mode!r}')
        if threshold_mode not in ('rel', 'abs'):
            raise ValueError(f'unknown threshold_mode {threshold_mode!r}')
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_mult = float(min_mult)
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.multiplier = 1.0

    def _is_better(self, a, best):
        eps = self.threshold * abs(best) if self.threshold_mode == 'rel' \
            else self.threshold
        return a > best + eps if self.mode == 'max' else a < best - eps

    def step(self, metric):
        """Returns True when the multiplier was just reduced."""
        m = float(metric)
        if self.best is None or self._is_better(m, self.best):
            self.best = m
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.multiplier = max(self.multiplier * self.factor,
                                  self.min_mult)
            self.num_bad = 0
            self.cooldown_counter = self.cooldown
            return True
        return False

"""Semantic segmentation: the model (SPT backbone + one classifier head per
supervised level) and the training task around it. Counterparts of
`SemanticSegmentationModel` and `SemanticTask` in
`superpoint_transformer_tpu/models/semantic.py`: the multi-stage
histogram loss, AdamW with cosine warm-up (or warm-up then the plateau
controller's multiplier) and a scaled LR on the attention parameters,
gradient accumulation with the semantics of `optax.MultiSteps`, and the
level-1 confusion matrix. `SemanticTask.train_step` also takes one step of
a group of ranks: data-parallel, or on one rank's shard of a node-sharded
batch (`parallel/mesh.py`).
"""
import torch
import torch.distributed as dist
from torch import nn

from ..loss.semantic import multi_stage_loss
from ..metrics.semantic import confusion_matrix_from_histogram
from ..nn.mlp import Classifier
from ..parallel.collectives import all_reduce_mean_
from ..optim.lr_scheduler import (cosine_with_warmup, make_optimizer,
                                  make_plateau_optimizer, set_lr)

__all__ = ['SemanticSegmentationModel', 'SemanticTask']


class SemanticSegmentationModel(nn.Module):
    """The SPT backbone `net` with one classifier head per supervised
    level, made on `device` (by default the device of `net`)."""

    def __init__(self, net, num_classes, device=None):
        super().__init__()
        if device is None:
            device = next(net.parameters()).device
        self.net = net
        self.num_classes = num_classes
        for i, d in enumerate(net.out_dim):
            self.add_module(f'head_{i}',
                            Classifier(d, num_classes, device=device))

    def forward(self, nag):
        """Returns the logits of levels 1..L, low to high: a list of
        [N_i, num_classes] f32."""
        return [getattr(self, f'head_{i}')(x)
                for i, x in enumerate(self.net(nag))]


class SemanticTask:
    """Owns the model, its optimizer and the step counts. A batch is a
    `PaddedNAG` of tensors with the label histograms `y` of the
    supervised levels (`data.padded.from_numpy(..., train=True)`) on the
    device of `net`, where the heads are made too.

    `scheduler` is 'cosine' (cosine warm-up) or 'plateau' (warm-up, then
    constant times `lr_mult`, which the Trainer's `ReduceOnPlateau` sets).
    With `accumulate_grad_batches` k > 1, `train_step` works as
    `optax.MultiSteps` around AdamW: the k micro-batch gradients are
    averaged and one update is applied on every k-th call; the
    parameters do not move in between. `step` counts calls (micro-steps,
    the JAX TrainState's step), `updates` counts optimizer updates (the
    inner optimizer's count, which indexes the LR schedule)."""
    # the JAX data-parallel and sharded steps take the semantic loss
    # alone; they raise on the panoptic task's
    parallel_steps = True

    def __init__(self, net, num_classes=13, loss_type='ce_kl',
                 multi_stage_loss_lambdas=(1., 50.), lr=0.01,
                 weight_decay=1e-4, transformer_lr_scale=0.1,
                 total_steps=100_000, warmup_steps=2_000,
                 warmup_init_lr=1e-6, eta_min=1e-6, class_weight=None,
                 scheduler='cosine', accumulate_grad_batches=1):
        if scheduler not in ('cosine', 'plateau'):
            raise ValueError(f'unknown scheduler {scheduler!r}')
        self.model = self._make_model(net, num_classes)
        self.num_classes = num_classes
        self.loss_type = loss_type
        self.lambdas = tuple(multi_stage_loss_lambdas)
        self.class_weight = class_weight
        self.scheduler = scheduler
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        opt = dict(lr=lr, weight_decay=weight_decay,
                   transformer_lr_scale=transformer_lr_scale,
                   num_warmup_steps=warmup_steps,
                   warmup_init_lr=warmup_init_lr)
        if scheduler == 'plateau':
            self.optimizer, self.schedules = make_plateau_optimizer(
                self.model, **opt)
        else:
            self.optimizer, self.schedules = make_optimizer(
                self.model, total_steps=total_steps, eta_min=eta_min,
                **opt)
        # the JAX task's host mirror of the cosine schedule, which its
        # Trainer logs whatever the scheduler
        self._logged_lr = cosine_with_warmup(
            lr, total_steps, warmup_steps, warmup_init_lr=warmup_init_lr,
            eta_min=eta_min)
        self.lr_mult = 1.0
        self.step = 0
        self.updates = 0
        self.mini_step = 0   # micro-batches accumulated since the update

    def _make_model(self, net, num_classes):
        """The model around `net`, made before the optimizer's groups."""
        return SemanticSegmentationModel(
            net, num_classes, device=next(net.parameters()).device)

    def lr_at(self, step):
        """The base group's cosine warm-up LR at `step`: the JAX task's
        host mirror, which reads the cosine schedule under the plateau
        scheduler too."""
        return self._logged_lr(step)

    def loss(self, batch):
        """(multi-stage loss, logits of levels 1..L) in the model's
        current mode. Supervised levels are 1..len(lambdas)."""
        logits = self.model(batch)
        return self._semantic_loss(logits, batch), logits

    def _semantic_loss(self, logits, batch, group=None):
        levels = [batch[1 + i] for i in range(len(self.lambdas))]
        cw = None
        if self.class_weight is not None:
            cw = torch.as_tensor(self.class_weight, dtype=torch.float32,
                                 device=logits[0].device)
        return multi_stage_loss(
            logits, [lvl.y for lvl in levels], self.lambdas,
            loss_type=self.loss_type, class_weight=cw,
            node_masks=[lvl.node_mask for lvl in levels], group=group)

    def _confmat(self, logits, batch):
        return confusion_matrix_from_histogram(
            logits[0].detach(), batch[1].y, self.num_classes,
            node_mask=batch[1].node_mask)

    def train_step(self, batch, group=None, sharded=False):
        """One micro-step on `batch`: its gradient joins the accumulated
        ones, and on every `accumulate_grad_batches`-th call one AdamW
        update on their mean, at the LR of the update count (times
        `lr_mult`). Returns {'loss': scalar tensor, 'confmat': [C, C]
        int64} computed before the update, like the JAX step.

        With `group` (a process group; every rank of it calls this with
        its own `batch`) the step is one update of the group:
        data-parallel, or with `sharded` on this rank's shard of one
        node-sharded batch, whose model was built with `group` as its
        `shard_group` (`parallel/mesh.py`)."""
        if group is not None:
            return self._group_step(batch, group, sharded)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self.loss(batch)
        loss.backward()
        k = self.accumulate_grad_batches
        if k > 1:
            self._accumulate()
        self.mini_step += 1
        self.step += 1
        if self.mini_step == k:
            if k > 1:
                for p, acc in zip(self.model.parameters(), self._acc):
                    p.grad = acc
            set_lr(self.optimizer, self.schedules, self.updates,
                   self.lr_mult)
            self.optimizer.step()
            self.updates += 1
            self.mini_step = 0
        return {'loss': loss.detach(), 'confmat': self._confmat(logits,
                                                                batch)}

    def check_group_step(self, group=None, sharded=False):
        """Raise ValueError where the data-parallel step, or with
        `sharded` the sharded step over `group`, refuses this task, as the
        JAX package does: a task other than the semantic one, gradient
        accumulation, a model built for the other step."""
        if not self.parallel_steps:
            raise ValueError(f'{type(self).__name__}: the data-parallel and '
                             'sharded steps take the semantic task only, as '
                             'in the JAX package')
        if self.accumulate_grad_batches > 1:
            raise ValueError('trainer.devices > 1 is incompatible with '
                             'accumulate_grad_batches > 1 (DP already '
                             'averages over the device axis)')
        net_group = getattr(self.model.net, 'shard_group', None)
        if sharded and (net_group is None or net_group is not group):
            raise ValueError('the sharded step needs the model built with '
                             'shard_group=group')
        if not sharded and net_group is not None:
            raise ValueError('a model built with a shard_group takes the '
                             'sharded step only')

    def _group_step(self, batch, group, sharded):
        """The data-parallel step (JAX `make_dp_train_step`): the mean of
        the ranks' gradients and of their losses, the sum of their
        confusion matrices. The sharded step (JAX
        `make_sharded_train_step`): the loss is a ratio of sums over the
        ranks, equal on every rank, and the confusion matrices are summed.
        In both the gradients are averaged over the ranks, in one bucket:
        a sharded rank back-propagates the replicated loss, and the
        collectives' backward sums the ranks' cotangents, so the ranks'
        gradients add up to world-size times the unsharded gradient (JAX
        sums them, and so steps on world-size times the gradient). Every
        rank then takes the same AdamW update of its replicated
        parameters."""
        self.check_group_step(group, sharded)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(batch)
        loss = self._semantic_loss(logits, batch,
                                   group=group if sharded else None)
        loss.backward()
        all_reduce_mean_([p.grad for p in self.model.parameters()
                          if p.grad is not None], group)
        set_lr(self.optimizer, self.schedules, self.updates, self.lr_mult)
        self.optimizer.step()
        self.step += 1
        self.updates += 1
        loss = loss.detach()
        cm = self._confmat(logits, batch)
        dist.all_reduce(cm, group=group)
        if not sharded:
            dist.all_reduce(loss, group=group)
            loss = loss / dist.get_world_size(group)
        return {'loss': loss, 'confmat': cm}

    def _accumulate(self):
        """Fold this micro-batch's gradients into their running mean, in
        optax.MultiSteps' arithmetic: acc + (g - acc) / (n + 1)."""
        n = self.mini_step
        if n == 0:
            # the next zero_grad drops these tensors from the parameters
            self._acc = [p.grad for p in self.model.parameters()]
            return
        for i, p in enumerate(self.model.parameters()):
            if p.grad is not None:
                acc = self._acc[i]
                self._acc[i] = p.grad.clone() if acc is None \
                    else acc + (p.grad - acc) / (n + 1)

    def state_dict(self):
        """Everything a resumed run needs: the model's and the optimizer's
        state, the step counts, the plateau multiplier, and the mean
        gradients of an unfinished accumulation."""
        grads = None
        if self.mini_step:
            grads = [None if g is None else g.detach().clone()
                     for g in self._acc]
        return {'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'step': self.step, 'updates': self.updates,
                'mini_step': self.mini_step, 'lr_mult': self.lr_mult,
                'grads': grads}

    def load_state_dict(self, state):
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        self.step = int(state['step'])
        self.updates = int(state['updates'])
        self.mini_step = int(state['mini_step'])
        self.lr_mult = float(state['lr_mult'])
        if state.get('grads') is not None:
            device = next(self.model.parameters()).device
            self._acc = [None if g is None else g.to(device).clone()
                         for g in state['grads']]

    @torch.no_grad()
    def eval_step(self, batch):
        """Loss, confusion matrix and level-1 logits in evaluation mode."""
        self.model.eval()
        loss, logits = self.loss(batch)
        return {'loss': loss, 'confmat': self._confmat(logits, batch),
                'logits_level1': logits[0]}

"""Semantic segmentation: the model (SPT backbone + one classifier head per
supervised level) and the training task around it. Counterparts of
`SemanticSegmentationModel` and `SemanticTask` in
`superpoint_transformer_tpu/models/semantic.py`: the multi-stage
histogram loss, AdamW with cosine warm-up and a scaled LR on the
attention parameters, and the level-1 confusion matrix. The JAX task's
gradient accumulation (optax.MultiSteps) and plateau scheduler are not
ported.
"""
import torch
from torch import nn

from ..loss.semantic import multi_stage_loss
from ..metrics.semantic import confusion_matrix_from_histogram
from ..nn.mlp import Classifier
from ..optim.lr_scheduler import make_optimizer, set_lr

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
    """Owns the model, its optimizer and the step count. A batch is a
    `PaddedNAG` of tensors with the label histograms `y` of the
    supervised levels (`data.padded.from_numpy(..., train=True)`) on the
    device of `net`, where the heads are made too."""

    def __init__(self, net, num_classes=13, loss_type='ce_kl',
                 multi_stage_loss_lambdas=(1., 50.), lr=0.01,
                 weight_decay=1e-4, transformer_lr_scale=0.1,
                 total_steps=100_000, warmup_steps=2_000,
                 warmup_init_lr=1e-6, eta_min=1e-6, class_weight=None):
        self.model = self._make_model(net, num_classes)
        self.num_classes = num_classes
        self.loss_type = loss_type
        self.lambdas = tuple(multi_stage_loss_lambdas)
        self.class_weight = class_weight
        self.optimizer, self.schedules = make_optimizer(
            self.model, lr=lr, weight_decay=weight_decay,
            transformer_lr_scale=transformer_lr_scale,
            total_steps=total_steps, num_warmup_steps=warmup_steps,
            warmup_init_lr=warmup_init_lr, eta_min=eta_min)
        self.step = 0

    def _make_model(self, net, num_classes):
        """The model around `net`, made before the optimizer's groups."""
        return SemanticSegmentationModel(
            net, num_classes, device=next(net.parameters()).device)

    def lr_at(self, step):
        """LR of the base parameter group at `step` (the JAX task's host
        mirror of its schedule)."""
        return self.schedules[0](step)

    def loss(self, batch):
        """(multi-stage loss, logits of levels 1..L) in the model's
        current mode. Supervised levels are 1..len(lambdas)."""
        logits = self.model(batch)
        return self._semantic_loss(logits, batch), logits

    def _semantic_loss(self, logits, batch):
        levels = [batch[1 + i] for i in range(len(self.lambdas))]
        cw = None
        if self.class_weight is not None:
            cw = torch.as_tensor(self.class_weight, dtype=torch.float32,
                                 device=logits[0].device)
        return multi_stage_loss(
            logits, [lvl.y for lvl in levels], self.lambdas,
            loss_type=self.loss_type, class_weight=cw,
            node_masks=[lvl.node_mask for lvl in levels])

    def _confmat(self, logits, batch):
        return confusion_matrix_from_histogram(
            logits[0].detach(), batch[1].y, self.num_classes,
            node_mask=batch[1].node_mask)

    def train_step(self, batch):
        """One AdamW step on `batch`, at the LR of the current step count.
        Returns {'loss': scalar tensor, 'confmat': [C, C] int64} computed
        before the update, like the JAX step."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self.loss(batch)
        loss.backward()
        set_lr(self.optimizer, self.schedules, self.step)
        self.optimizer.step()
        self.step += 1
        return {'loss': loss.detach(), 'confmat': self._confmat(logits,
                                                                batch)}

    @torch.no_grad()
    def eval_step(self, batch):
        """Loss, confusion matrix and level-1 logits in evaluation mode."""
        self.model.eval()
        loss, logits = self.loss(batch)
        return {'loss': loss, 'confmat': self._confmat(logits, batch),
                'logits_level1': logits[0]}

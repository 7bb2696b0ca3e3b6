"""EZ-SP's partition learning (stage 1): a light sparse CNN trained so that
point embeddings are homogeneous within objects and contrasted across
semantic boundaries; the partition itself is the greedy contour-prior
merge over the embeddings (`transforms/preprocess.py`). Counterparts of
`PartitionModel`, `PartitionTask` and `partition_purity` in
`superpoint_transformer_tpu/models/partition.py`.
"""
import numpy as np
import torch
from torch import nn

from ..loss.partition_criterion import partition_criterion
from ..nn.sparse import SparseCNN
from ..optim.lr_scheduler import make_optimizer, set_lr

__all__ = ['PartitionModel', 'PartitionTask', 'partition_purity']


class PartitionModel(nn.Module):
    """The sparse-CNN point embedding (EZ-SP's first stage; the widths of
    configs/model/partition/default_ezsp.yaml: in -> 32 -> 32 -> 32, with
    GraphNorm and LeakyReLU), in f32. The input width `in_channels` is
    that of the batch's `x`, which the JAX model reads at its first
    call. Weights are drawn from `generator` on the CPU."""

    def __init__(self, in_channels, channels=(32, 32, 32), norm='graph',
                 num_graphs=8, device=None, generator=None):
        super().__init__()
        self.cnn = SparseCNN(in_channels, channels, norm=norm,
                             num_graphs=num_graphs, device=device,
                             generator=generator)

    def forward(self, cloud):
        """Embeddings [N, channels[-1]] of a `PaddedPointCloud` of
        tensors; padded rows are zero."""
        return self.cnn(cloud.x, cloud.cnn_nbr_idx, batch=cloud.batch,
                        mask=cloud.node_mask)


class PartitionTask:
    """Owns the model, AdamW and the step count: the contrastive edge
    loss on the embeddings, AdamW on the cosine schedule in one group
    (the attention scale of 1 and no warm-up, as the JAX task's
    `make_optimizer` call). A batch is a `PaddedPointCloud` of tensors
    on the model's device, with label histograms `y`."""

    def __init__(self, model, num_classes=13, affinity_temperature=1.0,
                 adaptive_sampling_ratio=0.9, focal_gamma=1.0, lr=1e-4,
                 weight_decay=1e-4, total_steps=100_000, warmup_steps=0):
        self.model = model
        self.num_classes = num_classes
        self.affinity_temperature = affinity_temperature
        self.adaptive_sampling_ratio = adaptive_sampling_ratio
        self.focal_gamma = focal_gamma
        self.optimizer, self.schedules = make_optimizer(
            model, lr=lr, weight_decay=weight_decay,
            transformer_lr_scale=1.0, total_steps=total_steps,
            num_warmup_steps=warmup_steps)
        self.step = 0

    def loss(self, batch, train=True):
        """(loss, embeddings, aux) of `batch` in the model's current
        mode; `train` selects the criterion's intra-edge reweighting."""
        x = self.model(batch)
        loss, aux = partition_criterion(
            x, batch.y, batch.edge_index, edge_mask=batch.edge_mask,
            num_classes=self.num_classes,
            affinity_temperature=self.affinity_temperature,
            adaptive_sampling_ratio=self.adaptive_sampling_ratio,
            gamma=self.focal_gamma, train=train)
        return loss, x, aux

    def train_step(self, batch):
        """One AdamW update at the LR of the step count. Returns
        {'loss', 'n_inter_edge'} as tensors on the device, computed
        before the update, as the JAX step."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, _, aux = self.loss(batch, train=True)
        loss.backward()
        set_lr(self.optimizer, self.schedules, self.step)
        self.optimizer.step()
        self.step += 1
        return {'loss': loss.detach(), 'n_inter_edge': aux['n_inter_edge']}

    @torch.no_grad()
    def eval_step(self, batch):
        """The loss without the reweighting, the embeddings and the
        number of inter edges."""
        self.model.eval()
        loss, x, aux = self.loss(batch, train=False)
        return {'loss': loss, 'embeddings': x,
                'n_inter_edge': aux['n_inter_edge']}

    def embed(self, batch):
        """The embeddings of the valid rows, as a numpy array."""
        x = self.eval_step(batch)['embeddings']
        return x[:int(batch.num_nodes)].cpu().numpy()

    def state_dict(self):
        return {'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'step': self.step}

    def load_state_dict(self, state):
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        self.step = int(state['step'])


def partition_purity(super_index, y_hist, num_classes):
    """The oracle confusion matrix of a partition (the reference logs its
    metrics as partition_omiou / ooa / omacc): every superpoint predicts
    its majority label. Rows are ground truth, columns the prediction;
    its mIoU bounds a semantic segmentation on the partition."""
    y_hist = np.asarray(y_hist)[:, :num_classes]
    sp = np.asarray(super_index)
    n_sp = int(sp.max()) + 1 if sp.size else 0
    hist_sp = np.zeros((n_sp, num_classes), np.int64)
    np.add.at(hist_sp, sp, y_hist.astype(np.int64))
    major = hist_sp.argmax(1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    pred_per_point = major[sp]
    for c in range(num_classes):
        np.add.at(cm[c], pred_per_point, y_hist[:, c].astype(np.int64))
    return cm

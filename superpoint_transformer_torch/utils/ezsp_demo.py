"""EZ-SP on one NAG: train the partition embedding on its level-0 voxels,
partition it with the greedy contour-prior merge, and score the learned
partition's purity (oracle mIoU) against the NAG's own cut-pursuit
partition of the same voxels. Counterpart of
`superpoint_transformer_tpu/utils/ezsp_demo.py`, on any NAG (the
repository has no demo file; `utils/synthetic.py:synthetic_room_cloud`
through `preprocess_cloud` gives one).
"""
import time

import numpy as np
import torch

__all__ = ['run_ezsp_demo']


def run_ezsp_demo(nag, steps=200, seed=0, num_classes=13,
                  channels=(32, 32), reg=2e-2, min_size=(5, 30),
                  device='cuda'):
    """Train EZ-SP embeddings on `nag` for `steps` AdamW steps (LR 1e-3)
    on `device` (the card unless the caller asks for the CPU) and
    partition it. Returns a dict: the learned partition's level-1 oracle
    mIoU / OA and segment count, the same for the NAG's stored level 1,
    the first and last losses, the voxel count and the wall time."""
    from ..data.data import Data
    from ..metrics.oracle import semantic_segmentation_oracle
    from ..models.partition import PartitionModel, PartitionTask
    from ..transforms.prepare import BatchConfig, prepare_partition_batch
    from ..transforms.preprocess import greedy_contour_prior_partition

    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('run_ezsp_demo: no CUDA device; pass '
                           'device="cpu" to run on the CPU')
    cfg = BatchConfig(num_classes=num_classes)
    rng = np.random.default_rng(seed)
    # the criterion reweights intra edges by their expected rate (no
    # sampling), so one fixed batch of the whole NAG is the exact
    # objective of every step
    batch = prepare_partition_batch([nag], cfg, train=True, rng=rng,
                                    device=device)
    task = PartitionTask(
        PartitionModel(batch.x.shape[1], channels=channels, num_graphs=1,
                       device=device,
                       generator=torch.Generator().manual_seed(seed)),
        num_classes=num_classes, lr=1e-3, total_steps=steps)

    t0 = time.time()
    dev_losses = [task.train_step(batch)['loss'] for _ in range(steps)]
    losses = [float(x) for x in torch.stack(
        [dev_losses[0], dev_losses[-1]]).cpu()] if dev_losses \
        else [None, None]

    # embeddings of every voxel (an evaluation batch: no crop)
    ebatch = prepare_partition_batch([nag], cfg, train=False,
                                     device=device)
    emb = task.embed(ebatch)
    # the greedy partition over the adjacency that the batch used
    n = emb.shape[0]
    ei = ebatch.edge_index[:, ebatch.edge_mask].cpu().numpy()
    d0 = nag[0]
    data = Data(pos=np.asarray(d0.pos, np.float32)[:n],
                x=emb.astype(np.float32), y=np.asarray(d0.y)[:n],
                edge_index=ei.astype(np.int64))
    part = greedy_contour_prior_partition(
        data, reg=reg, min_size=list(min_size),
        edge_weight_mode='exp_neg_latent_distance')

    def oracle(y_hist):
        y = np.asarray(y_hist)[:, :num_classes].astype(np.int64)
        return semantic_segmentation_oracle(y, num_classes)

    learned, ref = oracle(part[1].y), oracle(nag[1].y)
    return {
        'learned_n_segments': int(part[1].num_nodes),
        'learned_oracle_miou': float(learned['miou']),
        'learned_oracle_oa': float(learned['oa']),
        'cutpursuit_n_segments': int(nag[1].num_nodes),
        'cutpursuit_oracle_miou': float(ref['miou']),
        'cutpursuit_oracle_oa': float(ref['oa']),
        'loss_first': losses[0], 'loss_last': losses[1],
        'steps': steps, 'n_voxels': int(n),
        'wall_sec': time.time() - t0,
    }

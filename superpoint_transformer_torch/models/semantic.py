"""Semantic segmentation model: SPT backbone + one classifier head per
supervised level (counterpart of `SemanticSegmentationModel` in
`superpoint_transformer_tpu/models/semantic.py`, forward only)."""
from torch import nn

from ..nn.mlp import Classifier

__all__ = ['SemanticSegmentationModel']


class SemanticSegmentationModel(nn.Module):

    def __init__(self, net, num_classes, device=None):
        super().__init__()
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

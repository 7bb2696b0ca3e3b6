"""Training losses of the PyTorch port."""
from .focal import binary_focal_loss, weighted_focal_loss
from .lovasz import lovasz_softmax_loss
from .weighted import (weighted_bce_with_logits_loss, weighted_l1_loss,
                       weighted_l2_loss)

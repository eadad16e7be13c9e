from gcc_tpu_torch.contrastive.losses import nce_softmax_loss
from gcc_tpu_torch.contrastive.moco import (
    MoCoQueue,
    enqueue,
    init_queue,
    moco_logits,
)

__all__ = ["MoCoQueue", "enqueue", "init_queue", "moco_logits",
           "nce_softmax_loss"]

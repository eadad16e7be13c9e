from gcc_tpu_torch.contrastive.losses import (
    batch_mean,
    e2e_logits,
    in_batch_loss,
    legacy_nce_probs,
    nce_softmax_loss,
)
from gcc_tpu_torch.contrastive.moco import (
    MoCoQueue,
    enqueue,
    init_queue,
    moco_logits,
)

__all__ = ["MoCoQueue", "batch_mean", "e2e_logits", "enqueue",
           "in_batch_loss", "init_queue", "legacy_nce_probs", "moco_logits",
           "nce_softmax_loss"]

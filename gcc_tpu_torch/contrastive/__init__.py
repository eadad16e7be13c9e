from gcc_tpu_torch.contrastive.losses import (
    e2e_logits,
    legacy_nce_probs,
    nce_softmax_loss,
)
from gcc_tpu_torch.contrastive.moco import (
    MoCoQueue,
    enqueue,
    init_queue,
    moco_logits,
)

__all__ = ["MoCoQueue", "e2e_logits", "enqueue", "init_queue",
           "legacy_nce_probs", "moco_logits", "nce_softmax_loss"]

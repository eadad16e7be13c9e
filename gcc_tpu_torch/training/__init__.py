from gcc_tpu_torch.training.pretrain import (
    PretrainState,
    create_pretrain_state,
    featurize_pair,
    featurize_stacked,
    train_dispatch,
    train_step,
)

__all__ = ["PretrainState", "create_pretrain_state", "featurize_pair",
           "featurize_stacked", "train_dispatch", "train_step"]

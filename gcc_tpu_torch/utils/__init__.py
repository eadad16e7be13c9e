from gcc_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter"]

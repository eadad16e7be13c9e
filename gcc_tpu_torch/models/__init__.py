from gcc_tpu_torch.models.encoder import GraphEncoder

__all__ = ["GraphEncoder"]

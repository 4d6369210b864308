from rtwc_tpu_torch.engine.engine import Engine

__all__ = ["Engine"]

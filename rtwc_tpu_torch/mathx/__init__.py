from rtwc_tpu_torch.mathx.core import dot, normalize, safe_normalize, tensor_dataclass

__all__ = ["dot", "normalize", "safe_normalize", "tensor_dataclass"]

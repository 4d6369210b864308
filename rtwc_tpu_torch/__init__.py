"""rtwc_tpu_torch: the PyTorch / CUDA port of the console ray tracer.

A second package beside `rtwc_tpu` (the JAX reference, which stays as it
is). It runs the interactive display path end to end on an NVIDIA Hopper
card: scene physics, the hard closest-hit render (a CUDA kernel written by
hand, csrc/hard_render.cu), the anti-aliasing downsample, the mode heads,
the ANSI encoder and the presenter; and the differentiable soft render
with and without shadows, its gradients and the fused MSE train step
(csrc/soft_render.cu, csrc/soft_shadow.cu). It imports torch and numpy,
never jax and nothing of the JAX package: where it needs a module of that
package (the config, the native C++ encoder) it keeps its own copy.

Counterpart: rtwc_tpu/__init__.py:1-14.
"""
from rtwc_tpu_torch.config import RenderConfig, EngineConfig, RenderMode

__version__ = "0.1.0"

__all__ = ["RenderConfig", "EngineConfig", "RenderMode", "__version__"]

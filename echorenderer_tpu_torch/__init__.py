"""echorenderer_tpu_torch — the PyTorch/CUDA port of echorenderer_tpu.

The same path tracer, module for module (the subpackages keep the JAX
package's names), running on one device chosen at
`scene.prepare.prepare_scene(scene, device=...)`. The TPU's Pallas kernels
become hand-written CUDA kernels for Hopper (csrc/), each with a plain
PyTorch version beside it that serves CPU tensors. This package imports
torch and numpy only.
"""

__version__ = "0.1.0"

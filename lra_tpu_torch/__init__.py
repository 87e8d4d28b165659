"""lra_tpu_torch: the lra_tpu long-read aligner on PyTorch and CUDA.

A second implementation of lra_tpu (the JAX reference package beside it)
for one NVIDIA Hopper GPU.  Host stages (I/O, index build, anchors,
clustering, chain surgery, CIGAR emission) are the reference's numpy and
C++ code, copied; the device rounds run on torch tensors, and every
kernel lra_tpu ran on the TPU is a hand-written CUDA kernel here
(csrc/, built with nvcc at first use, bound with ctypes), each with a
plain torch twin that runs wherever its tensors lie on the CPU.

The package imports torch and numpy, never jax and nothing of lra_tpu.
Entry points take an explicit ``device`` and run on "cuda" by default;
"cpu" is an explicit opt-in (the tests use it).
"""

from .options import Options, ReadType, preset

__version__ = "0.1.0"

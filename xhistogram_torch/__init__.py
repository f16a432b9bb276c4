"""xhistogram_torch: axis-selective joint histograms in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``xhistogram_tpu`` (the JAX package beside it, which
stays the reference the port is tested against). Module names follow the
JAX package so each counterpart is easy to find:

  - ``xhistogram_torch.core.histogram`` — array API
  - ``xhistogram_torch.bins``           — host-side bin-edge handling
  - ``xhistogram_torch.ops``            — digitize, bincount, and the CUDA
    kernels with their plain PyTorch versions (``ops.cuda_hist``)

Importing the package needs neither a GPU nor a CUDA compiler: kernels are
built at their first launch.
"""

__version__ = "0.1.0"

from .core import histogram  # noqa: F401

__all__ = ["histogram", "__version__"]

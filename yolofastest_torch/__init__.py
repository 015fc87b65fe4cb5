"""yolofastest_torch — the PyTorch/CUDA port of ``yolofastest_tpu``.

A second package beside the JAX one, for one NVIDIA H100: plain tensor code
is PyTorch, and each kernel the JAX package wrote in Pallas is a CUDA kernel
written by hand for Hopper (``kernels/csrc``), built at first use.  Module
names mirror the JAX package's, so each counterpart is easy to find.  The
port imports neither JAX nor anything of ``yolofastest_tpu``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
without a card they raise rather than move to the CPU.
"""

__version__ = "0.1.0"

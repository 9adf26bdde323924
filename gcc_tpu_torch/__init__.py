"""GCC on PyTorch + CUDA: the port of ``gcc_tpu`` to one NVIDIA H100.

Plain tensor code is PyTorch in NCHW; every kernel the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use (``gcc_tpu_torch.ops.kernels``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each kernel
wrapper runs its plain PyTorch version.
"""

"""AMMCNet in PyTorch for one NVIDIA H100: a port of ``ammcnet_aaai2021_tpu``.

The JAX package stays the reference; this package imports nothing of it.
Plain tensor code is PyTorch (NCHW); the JAX package's Pallas kernels become
hand-written CUDA kernels under ``csrc/``, built at first use on the card.
"""

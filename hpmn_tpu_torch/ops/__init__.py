"""Ops: the plain GRU (``gru``) and the CUDA kernel wrappers
(``cuda_gru``, ``cuda_readout``), built by ``_build``."""

"""Hand-written Hopper (sm_90a) kernels of the port, each beside its plain
PyTorch version; sources in ``csrc/``, built at first use by ``_build``."""

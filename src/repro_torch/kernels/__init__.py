"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers, their
plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""

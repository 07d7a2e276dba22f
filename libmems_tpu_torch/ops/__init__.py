"""Device operators of the port: each holds a hand-written CUDA kernel
(csrc/) and its plain PyTorch version."""

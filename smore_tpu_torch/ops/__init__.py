"""Update kernels: hand-written CUDA for Hopper, each with a PyTorch twin."""

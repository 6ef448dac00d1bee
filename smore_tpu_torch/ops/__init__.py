"""Hand-written CUDA kernels for Hopper, the updates' and the walk's, each
with a PyTorch twin."""

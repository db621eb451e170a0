"""Frozen plain-PyTorch copies of the port's model modules, the benchmark's
references build on. Nothing here imports the port or runs a CUDA kernel."""

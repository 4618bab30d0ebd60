"""Benchmark of the PyTorch / CUDA rasterizer port on one NVIDIA card."""

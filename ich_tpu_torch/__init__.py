"""PyTorch + CUDA port of ich_tpu for the NVIDIA H100."""

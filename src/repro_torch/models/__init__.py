"""The LM scaffold's models on PyTorch: dense decoder-only serving."""

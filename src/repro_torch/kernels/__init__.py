"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``): the Vcycle kernels with their Program binding
(``ops.py``), flash attention with its two kernels' wrappers and their
routing (``flash_attention.py``).
``build.py`` compiles them all into one library."""

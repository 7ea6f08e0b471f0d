"""``repro_torch`` — the Manticore simulator on PyTorch and CUDA.

The port of ``repro`` (JAX on a TPU) to an NVIDIA H100. It imports torch
and numpy only, never JAX and nothing of ``repro``: the numpy-only compiler
and circuit modules are kept as copies, so both packages compile
byte-identical Programs. The entry point is :mod:`repro_torch.sim`::

    import repro_torch.sim as sim

    results = sim.compile("mc", seeds=range(512)).run()   # on the card

The chunked Vcycle engine (``core.bsp``) runs the hand-written CUDA kernel
``kernels/csrc/vcycle_chunk.cu``; ``device="cpu"`` selects its plain
PyTorch version. ``convert`` carries Programs, machine states and LM
parameters across from the reference package as numpy arrays.

The LM scaffold serves and trains: ``launch.steps.make_serve_steps`` and
``make_train_step`` over ``models`` and ``configs``, with attention on
the kernels ``kernels/csrc/flash_attention_sm90.cu`` (bf16, head dims 64
and 128, on the tensor cores) and ``kernels/csrc/flash_attention.cu``
(float32 and the other head dims) and their backward kernels, on one
device or data-parallel over a mesh of devices (``distributed``,
``launch.mesh``).
"""

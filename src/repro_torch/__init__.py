"""PyTorch port of the lakehouse (``repro``), for NVIDIA Hopper GPUs.

Same layout as ``repro``: each module sits at the same relative path as
its counterpart (``repro_torch/core/catalog.py`` ↔
``repro/core/catalog.py``). The port imports no JAX and no module of
``repro``; what it needs from a JAX-free module there it keeps as its own
copy. Group-by aggregation runs in the hand-written CUDA kernels of
``kernels/segment_sum``; entry points run on the card (``cuda``) unless
the caller asks for the CPU.
"""

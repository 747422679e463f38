"""repro_torch — the PyTorch/CUDA port of ``repro``, grown slice by slice.

It mirrors the JAX package's module layout and imports neither JAX nor
``repro``: the framework-neutral modules it needs are its own copies.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a CUDA
tensor the hand-written Hopper kernels under ``repro_torch.kernels`` run, on
a CPU tensor their plain PyTorch versions do.
"""

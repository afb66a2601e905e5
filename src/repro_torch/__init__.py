"""``repro_torch`` — the tiny-task subsampling platform in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

It mirrors the module layout of the JAX package ``repro`` (the reference
it is tested against) and imports neither JAX nor anything of ``repro``.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version; asking for the card where there is none raises.
"""

"""showo_tpu_torch — the PyTorch + CUDA port of ``showo_tpu``.

The JAX package ``showo_tpu`` is the reference; this package mirrors its
module names (``ops/masks.py``, ``ops/flash_attention.py``,
``models/phi.py`` ...) so each counterpart is easy to find, and keeps its
layouts at the public functions: NHWC images in [-1, 1], packed
``[B, S, H*D]`` attention, ``[B, 1, Q, K]`` additive bias.

The port imports ``torch`` and never ``jax``, nor the JAX package: the
host code it needs (``config.py``, the t2i and training parts of
``prompting.py``, the stand-in tokenizer ``utils/fake_tokenizer.py``, the
checkpoint reader in ``utils/convert.py``) has its own copy here, held to
the JAX package's by the tests.  Hand-written CUDA kernels live under
``csrc/`` and are built with ``nvcc`` at first use (see
``ops/cuda_build.py``).

Ported so far: the Show-o v1 text-to-image path (prefix-cached MaskGIT
with CFG, MAGVIT-v2 decode) on four inference attention kernels, and the
v1 stage-1 trainer (``training/``: MAGVIT-v2 encode, corruption, the
fused t2i + lm + mmu step, AdamW) on the trainable attention kernels
(forward, dq, dk/dv).  The entry points run on CUDA unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"

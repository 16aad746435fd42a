"""PyTorch + CUDA port of ceph_tpu for NVIDIA Hopper (H100).

Mirrors ceph_tpu's module paths: ``ceph_tpu_torch.ec.engine`` is the
counterpart of ``ceph_tpu.ec.engine`` and so on.  Imports torch, numpy and
the standard library only, never JAX and never ceph_tpu.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; with no device given
and no CUDA present they raise.

The port so far covers the erasure-code data path of the jax_rs, xor, lrc,
shec and clay codecs (encode, decode, degraded read, recovery, and CLAY's
regenerating repair); the GF(2) region apply runs in the hand-written CUDA
kernels of ``csrc/``.
"""

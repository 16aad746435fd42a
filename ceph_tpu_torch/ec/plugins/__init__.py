"""Erasure code plugins of the port.

Each module exposes ``__erasure_code_init__(registry)``, as in
ceph_tpu.ec.plugins.  Ported so far: ``jax_rs`` (every technique, GF(2^8)
and packet codes) and ``xor``.
"""

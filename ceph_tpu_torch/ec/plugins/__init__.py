"""Erasure code plugins of the port.

Each module exposes ``__erasure_code_init__(registry)``, as in
ceph_tpu.ec.plugins: ``jax_rs`` (every technique, GF(2^8) and packet
codes), ``xor``, ``lrc`` (layers of port codecs), ``shec`` and ``clay``
(regenerating code; inner jax_rs or shec).
"""

"""The benchmark of ceph_tpu_torch: RADOS traffic on an 8+4
erasure-coded pool served by the port's OSD daemons on one card.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md gives the
layout.  Nothing here imports jax, jaxlib or ceph_tpu.
"""

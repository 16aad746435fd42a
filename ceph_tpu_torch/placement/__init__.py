"""CRUSH-compatible placement (reference src/crush, SURVEY.md §2.3).

Counterpart of ceph_tpu/placement/__init__.py: the same package over the
port's imports.  Straw2 weighted draws + rjenkins1 mixing implemented as
vectorized integer math (numpy on the host, uint32 wrap-around and int64
truncating division) instead of the reference's per-item C loops. The
semantics preserved:

- rjenkins1 hash32 1..5-arg mixes (reference src/crush/hash.c)
- straw2 exponential draw via fixed-point log (mapper.c:361,
  crush_ln mapper.c:248, table formulas crush_ln_table.h)
- crush_do_rule step machine: take / choose(leaf)_firstn / choose(leaf)_indep
  / emit with collision/out retries (mapper.c:900, :461 firstn, :650 indep)
- is_out reweight test (mapper.c:424)
"""

from ceph_tpu_torch.placement.crush_map import Bucket, CrushMap, Rule  # noqa: F401
from ceph_tpu_torch.placement.hashing import crush_hash32_2, crush_hash32_3  # noqa: F401

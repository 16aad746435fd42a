"""Offline disaster-recovery tool suite (reference src/tools/).

Counterpart of ceph_tpu/tools/__init__.py: the same module over the
port's imports.

Three operator-facing tools that work with every daemon stopped:

- ``monstore_tool``  — dump/inspect a MonitorDBStore, and ``rebuild``:
  reconstruct a dead quorum's store from surviving OSD data (the
  ceph-monstore-tool + ceph-objectstore-tool update-mon-db role).
- ``osdmaptool``     — print/diff OSDMaps, simulate the whole PG space
  (``--test-map-pgs``, riding the vectorized placement/bulk mapper),
  and propose pg-upmap-items rebalancing (``--upmap``).
- ``monmaptool``     — create/print/add/rm monmaps so a rebuilt store
  can be pointed at a new quorum.

Each module exposes ``build_parser()`` + ``async _run(args)`` +
``main(argv)`` (the rbd_tool convention) so tests can drive the real
argv surface inside an existing event loop.
"""

"""Entry points of the port (counterpart of __graft_entry__.py).

- ``entry()``            — the single-device forward step on the flagship
  codec (jax_rs RS k=8 m=4): the parity bitmatrix applied to a batch of
  stripes by B1 (``cuda_kernels.gf2_apply_words``) on the card.
- ``dryrun_multichip(n)`` — the full distributed EC step (encode,
  all_to_all chunk fan-out over the 'cs' axis, all_gather repair), the
  CLAY and LRC mesh repairs and the daemon's ``ShardedApplier`` over an
  n-slot mesh on small shapes, each check printing a line.

Where the process has fewer than n devices, ``dryrun_multichip`` forces n
slots over the one it has (``parallel.mesh.forced_device_count``) for the
run: the port needs no subprocess, since forcing slots re-initialises
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

_APPLIERS: dict = {}


def _apply_bitmatrix(bits_matrix: torch.Tensor,
                     stripes: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) 0/1 bitmatrix x (B, k, C) uint8 -> (B, m, C) uint8 (the
    JAX engine's ``bitplane_apply``).  The matrix's kernel constants are
    built once per matrix tensor (while it is unchanged); on a GPU the
    apply launches B1, on the CPU it runs B1's plain version."""
    from ceph_tpu_torch.ec import cuda_kernels as ck

    key = (id(bits_matrix), bits_matrix._version)
    hit = _APPLIERS.get(key)
    if hit is None or hit[0] is not bits_matrix:
        bitmatrix = bits_matrix.to(torch.uint8).cpu().numpy()
        hit = (bits_matrix, ck.ShardApply(bitmatrix=bitmatrix))
        _APPLIERS.clear()
        _APPLIERS[key] = hit
    return hit[1](stripes)


def entry(device=None):
    """Return (fn, example_args): batched EC encode, k=8 m=4, on
    ``device`` (CUDA when None, raising without it)."""
    from ceph_tpu_torch.ec import bitmatrix as bm
    from ceph_tpu_torch.ec.engine import resolve_device
    from ceph_tpu_torch.ec.matrix import generator_matrix

    dev = resolve_device(device)
    k, m = 8, 4
    G = generator_matrix("reed_sol_van", k, m)
    mat = torch.from_numpy(
        np.asarray(bm.gf_matrix_to_bitmatrix(G[k:]), np.uint8)).to(dev)
    data = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (64, k, 512), np.uint8)
    ).to(dev)

    def fn(bits_matrix, stripes):
        return _apply_bitmatrix(bits_matrix, stripes)

    return fn, (mat, data)


def _dryrun_body(n_devices: int, device=None) -> None:
    """The multichip dryrun on the first ``n_devices`` local devices of
    ``device``'s kind."""
    from ceph_tpu_torch.ec.matrix import generator_matrix
    from ceph_tpu_torch.parallel import distributed_ec_step, make_ec_mesh
    from ceph_tpu_torch.parallel.mesh import local_devices

    devices = local_devices(device)[:n_devices]
    n_got = len(devices)
    if n_got < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {n_got}; "
            "run via dryrun_multichip() which forces the slots"
        )
    # Derive cs from the device count actually obtained, never the request.
    # cs must divide both n_got and k+m=12: prefer 4, else 2, else 1.
    cs = next(c for c in (4, 2, 1) if n_got % c == 0)
    mesh = make_ec_mesh(devices, cs=cs)
    # Every check prints a line, so a run leaves a record to audit.
    print(f"mesh: {n_got} devices, dp={n_got // cs} cs={cs}", flush=True)
    k, m = 8, 4
    G = generator_matrix("reed_sol_van", k, m)
    B = 2 * n_got
    data = np.random.default_rng(1).integers(0, 256, (B, k, 128), np.uint8)
    shard, repaired = distributed_ec_step(mesh, G, data, lost_chunk=3)
    assert np.asarray(shard).shape == (B, k + m, 128)
    assert np.asarray(repaired).shape == (B, 128)
    print(f"distributed_ec_step: OK (B={B}, repaired chunk 3)", flush=True)

    # BASELINE config #4: CLAY k=8 m=4 d=11 — the d-helper sub-chunk reads
    # ride the mesh as a 'cs'-group all_gather of repair planes.
    from ceph_tpu_torch.parallel import sharded_clay_repair_check

    sharded_clay_repair_check(mesh)
    print("clay sub-chunk repair check: OK", flush=True)

    # BASELINE config #5: LRC k=12 m=4 group-local all_gather repair.
    from ceph_tpu_torch.parallel import sharded_lrc_repair_check
    from ceph_tpu_torch.parallel.lrc_sharding import LRC_CHECK_GROUPS

    if n_got % LRC_CHECK_GROUPS == 0:
        sharded_lrc_repair_check(mesh)
        print("lrc group-local repair check: OK", flush=True)
    else:
        print(f"lrc check skipped ({n_got} devices not a multiple of "
              f"{LRC_CHECK_GROUPS} groups)", flush=True)

    # The daemon's data plane: ECBackend dispatches encode + reconstruct
    # batches through ShardedApplier when a mesh is configured — validate
    # the exact appliers it builds, bit-identical to the single-device
    # reference encode.
    from ceph_tpu_torch.ec import reference
    from ceph_tpu_torch.parallel.ec_sharding import (ShardedApplier,
                                                     shard_layout)

    enc = ShardedApplier(mesh, G[k:])
    # per-device launch accounting read off the REAL addressable shards
    # of a placed launch — the record that the batch axis actually
    # split, not an assumption from the mesh shape
    placed = enc.place(data)
    layout = shard_layout(placed)
    assert len(layout) == n_got and all(r > 0 for r in layout.values())
    assert sum(layout.values()) == B
    print("per-device stripes: "
          + " ".join(f"d{d}:{r}" for d, r in sorted(layout.items())),
          flush=True)
    parity = np.asarray(enc.run_placed(placed))
    expect = reference.encode(G, np.transpose(data, (1, 0, 2))
                              .reshape(k, -1))
    assert np.array_equal(
        parity, np.transpose(expect[k:].reshape(m, B, 128),
                             (1, 0, 2)))
    survivors = list(range(1, k + 1))
    D = reference.decode_matrix(G, survivors, [0])
    dec = ShardedApplier(mesh, D)
    chunks = np.concatenate([data, parity], axis=1)
    rebuilt = dec(chunks[:, survivors])
    assert np.array_equal(rebuilt[:, 0], data[:, 0])
    print("sharded applier encode/decode: bit-identical", flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the full distributed EC step over an n_devices mesh on
    ``device``'s kind (CUDA when None, raising without it; ``"cpu"`` when
    asked for).  With fewer local devices than n_devices, n_devices slots
    are forced over ``device`` for the run, and the setting before it
    comes back after."""
    from ceph_tpu_torch.parallel.mesh import (forced_device_count,
                                              local_devices)

    if len(local_devices(device)) >= n_devices:
        _dryrun_body(n_devices, device)
        return
    with forced_device_count(n_devices, device):
        _dryrun_body(n_devices, device)

"""Shapes of the split-L device CRC on the card, side by side.

    python -m ceph_tpu_torch.testing.crc_builds

``ec.checksum.CrcPlan`` computes the CRC's linear part as a chain of B2
launches: step 1 over segments of P bytes, folds of at most F segment
partials, then the 16 lanes folded by the lane fans.  For the OSD path's
two shapes, the write path's (12, 65536) and the scrub group's
(768, 65536), this prints one JSON line per plan: its launches, its device
time (CUDA events around 20 eager calls, median of 5: the chain as the OSD
path issues it, host enqueue included where it is the longer), the host
time per call (back-to-back calls, no synchronise), and whether it equals
the plain version (``checksum.crc_bits_plain``).  Beside them: the old
form (one B2 launch of the (4 x L) contraction over the (L, B)
transpose), the transpose alone, and the JAX package's own form as a
library yardstick (``crc_bits_matmul``: bit expansion, a bf16 matmul with
float32 accumulation, ``& 1``, repack).  Needs a card and the CUDA
toolkit; writes nothing outside ``_build/``.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.ec import benchmark, checksum
from ceph_tpu_torch.ec import cuda_kernels as ck

SHAPES = ((12, 1 << 16), (768, 1 << 16))
SEG_BYTES = (256, 512, 1024, 2048, 4096)
SEG_FANS = (4, 8, 16)
LANE_FANS = ((16,), (4, 4), (2, 2, 2, 2))
SEED = 20261017


def crc_bits_matmul(streams: torch.Tensor) -> torch.Tensor:
    """The JAX package's form of Lmap (its engine's bitplane_apply): the
    streams' bits as a (B, 8L) bf16 matrix times the (8L, 32) bf16
    bitmatrix with float32 accumulation and output (``torch.mm`` with
    ``out_dtype``, exact: sums <= 8L < 2^24), ``& 1``, repacked to (B, 4)
    uint8."""
    B, L = int(streams.shape[0]), int(streams.shape[1])
    dev = streams.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((streams[:, :, None] >> shifts) & 1).reshape(B, 8 * L)
    acc = torch.mm(bits.to(torch.bfloat16), _bitmatrix_bf16(L, dev),
                   out_dtype=torch.float32)
    pb = (acc.to(torch.int32) & 1).reshape(B, 4, 8)
    weights = torch.ones(8, dtype=torch.int32, device=dev) << torch.arange(
        8, dtype=torch.int32, device=dev)
    return (pb * weights).sum(dim=2).to(torch.uint8)


_MATS: dict = {}


def _bitmatrix_bf16(length: int, dev: torch.device) -> torch.Tensor:
    key = (length, str(dev))
    if key not in _MATS:
        _MATS[key] = torch.from_numpy(
            checksum.crc_bitmatrix(length).T.astype(np.float32)).to(
                dev, torch.bfloat16).contiguous()
    return _MATS[key]


def host_seconds_per_call(fn, calls: int = 50) -> float:
    """Host clock over ``calls`` back-to-back calls with no synchronise
    between them: what one call costs to enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sec = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return sec


def main() -> int:
    if not torch.cuda.is_available():
        print("crc_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for B, L in SHAPES:
        streams = torch.randint(0, 256, (B, L), dtype=torch.uint8,
                                generator=gen).to(dev)
        plain = checksum.crc_bits_plain(streams)
        old = ck.GF2Constants(checksum.crc_bitmatrix(L))
        col = streams.t().contiguous()
        if not torch.equal(ck.gf2_apply_u8(old, col).t(), plain):
            raise AssertionError("the old form differs from the plain one")
        jax_bits = crc_bits_matmul(streams)
        base = {"shape": [B, L],
                "old_one_launch_us": benchmark.cuda_seconds_per_call(
                    lambda: ck.gf2_apply_u8(old, streams.t().contiguous()),
                    iterations=2, runs=3, warmup=1) * 1e6,
                "transpose_us": benchmark.cuda_seconds_per_call(
                    lambda: streams.t().contiguous()) * 1e6,
                "matmul_exact": bool(torch.equal(jax_bits, plain)),
                "matmul_us": benchmark.cuda_seconds_per_call(
                    lambda: crc_bits_matmul(streams), iterations=5) * 1e6}
        print(json.dumps(base), flush=True)
        for seg, fan, lanes in itertools.product(SEG_BYTES, SEG_FANS,
                                                 LANE_FANS):
            plan = checksum.CrcPlan(L, seg, fan, lanes)
            got = plan(streams)
            rec = {"shape": [B, L], "seg": seg, "seg_fan": fan,
                   "lane_fans": list(lanes), "launches": plan.launches,
                   "exact": bool(torch.equal(got, plain)),
                   "us": benchmark.cuda_seconds_per_call(
                       lambda: plan(streams), iterations=20) * 1e6,
                   "host_us": host_seconds_per_call(
                       lambda: plan(streams)) * 1e6}
            print(json.dumps(rec), flush=True)
            if not rec["exact"]:
                raise AssertionError(f"plan {rec} differs from the plain "
                                     f"version")
        del streams, col, plain
    return 0


if __name__ == "__main__":
    sys.exit(main())

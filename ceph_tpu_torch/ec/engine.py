"""GF(2) bitmatrix region ops on PyTorch tensors (counterpart of
ceph_tpu/ec/engine.py).

The hot op of the framework (the analog of isa-l ``ec_encode_data`` /
``jerasure_matrix_encode``): apply an (8m x 8k) GF(2) bitmatrix to byte
chunks.  On a CUDA tensor every apply launches one of the hand-written
kernels of ``cuda_kernels`` (csrc/gf2_apply.cu), including the shapes the
JAX engine sends to its XLA einsum (lengths that are not a multiple of 4,
packet layouts): the byte kernel takes any length.  On a CPU tensor the
same entries run the kernels' plain PyTorch versions.

Sparse repair operators (CLAY regenerating repair) go to the grouped
kernels instead: ``apply`` and ``apply_words`` ask ``grouped_applier``
first, as the JAX engine asks ``_grouped_applier`` (engine.py:220-232,
:243-248, :267-272), and the same matrices are grouped on both sides
(``cuda_kernels.GroupedPlan`` is the JAX plan's copy).  Unlike the JAX
engine, which groups only lengths that are a multiple of 4 on a TPU, the
port groups every shape on every device.

``bitplane_apply`` and ``packet_bitmatrix_apply`` are the plain PyTorch
versions of the JAX engine's einsum formulations, kept as oracles.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.common.cache import FIFOCache
from ceph_tpu_torch.ec import cuda_kernels as ck


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.  None means CUDA and
    raises when no CUDA device is present: nothing falls back to the CPU
    unless the caller asks for it with ``device="cpu"``.  A bare "cuda"
    gets the current device's index, so it compares equal to a tensor's
    device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def bitplane_apply(bits_matrix: torch.Tensor,
                   data: torch.Tensor) -> torch.Tensor:
    """(P, Q) float32 0/1 matrix x (B, Q/8, C) uint8 -> (B, P/8, C) uint8.

    Plain version of the JAX engine's bitplane_apply (bit planes, float32
    contraction, mod 2, repack; exact since sums <= Q < 2^24).  It is the
    same function as the byte kernel, whose plain version it calls."""
    return ck.gf2_apply_u8_plain(bits_matrix, data)


def packet_bitmatrix_apply(bits_matrix: torch.Tensor, data: torch.Tensor,
                           w: int) -> torch.Tensor:
    """(P, Q) float32 0/1 bitmatrix x (B, Q/w, C) uint8 -> (B, P/w, C) in
    PACKET layout: each chunk is w packets of C/w bytes; output packet r
    of chunk i is the GF(2) combination selected by bitmatrix row i*w + r
    (jerasure_schedule_encode semantics).  Plain version of the JAX
    engine's packet_bitmatrix_apply, by its own formulation: the packet
    axis is the contraction axis and the 8 bits of each packet byte ride
    the columns."""
    B, k, C = data.shape
    pkt = C // w
    pk = data.reshape(B, k * w, pkt)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((pk[:, :, :, None] >> shifts) & 1).reshape(B, k * w, pkt * 8)
    acc = torch.einsum("pq,bqc->bpc", bits_matrix, bits.to(torch.float32))
    obits = (acc.to(torch.int32) & 1).reshape(B, -1, pkt, 8)
    weights = torch.ones(8, dtype=torch.int32, device=data.device) \
        << torch.arange(8, dtype=torch.int32, device=data.device)
    by = (obits * weights).sum(dim=3).to(torch.uint8)
    return by.reshape(B, -1, C)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1).

    Shape-bucketing policy for batched device launches (see the JAX
    engine): rounding B up to a power of two bounds the population of
    launch shapes while wasting < 2x compute worst-case; GF region ops are
    row-independent, so zero-padded rows never perturb real rows."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def pad_batch_pow2(arr: np.ndarray) -> tuple[np.ndarray, int]:
    """Zero-pad the leading (batch/stripe) axis of ``arr`` up to its
    pow2_bucket.  Returns (padded, original_B); no copy when B is already
    a bucket size."""
    arr = np.asarray(arr, np.uint8)
    b = arr.shape[0]
    bp = pow2_bucket(b)
    if bp == b:
        return arr, b
    pad = np.zeros((bp - b,) + arr.shape[1:], np.uint8)
    return np.concatenate([arr, pad], axis=0), b


def pad_batch_pow2_device(arr: torch.Tensor) -> tuple[torch.Tensor, int]:
    """pad_batch_pow2 for a device tensor: the zero padding is allocated
    on the tensor's device, so the batch never round-trips through the
    host."""
    b = int(arr.shape[0])
    return pad_batch_to(arr, pow2_bucket(b)), b


def mesh_bucket(n: int, total_devices: int) -> int:
    """Batch bucket for a mesh-sharded launch: pow2_bucket rounded up to
    a whole number of device blocks, so every device gets the same stripe
    count."""
    bp = pow2_bucket(n)
    t = max(1, int(total_devices))
    if bp % t:
        bp = -(-bp // t) * t
    return bp


def pad_batch_to(arr, target: int):
    """Zero-pad the leading axis of a numpy array or a tensor up to
    ``target`` rows (>= current B) without changing its kind: numpy stays
    numpy, a tensor pads with zeros on its own device."""
    b = int(arr.shape[0])
    if target == b:
        return arr
    if isinstance(arr, np.ndarray):
        pad = np.zeros((target - b,) + arr.shape[1:], np.uint8)
        return np.concatenate([np.asarray(arr, np.uint8), pad], axis=0)
    pad = torch.zeros((target - b,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, pad], dim=0)


def _key(coeff: np.ndarray) -> bytes:
    """Cache key of a coefficient matrix: its bytes and shape."""
    return coeff.tobytes() + repr(coeff.shape).encode()


class BitplaneEngine:
    """Per-matrix applier cache and the region-op entries, on one device.

    Plays the role of ErasureCodeIsaTableCache: each coefficient matrix's
    kernel constants are built once and cached (FIFO-bounded), keyed by
    the matrix bytes and shape.  Inputs are tensors on ``self.device`` or
    numpy arrays, which are copied there; a tensor on another device is
    refused rather than moved.
    """

    def __init__(self, device=None, max_cached_matrices: int = 256):
        self.device = resolve_device(device)
        self._appliers: FIFOCache[ck.ShardApply] = FIFOCache(
            max_cached_matrices)
        # GroupedApply, or _NOT_GROUPABLE for a matrix whose plan does not
        # pay (cached either way, as the JAX engine's _grouped_cache)
        self._grouped: FIFOCache = FIFOCache(max_cached_matrices)

    def tensor(self, data, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        """``data`` as a tensor on this engine's device."""
        if isinstance(data, torch.Tensor):
            if data.device != self.device:
                raise ValueError(
                    f"tensor on {data.device}, engine on {self.device}"
                )
            if data.dtype != dtype:
                raise TypeError(f"expected {dtype}, got {data.dtype}")
            return data
        np_dtype = np.uint8 if dtype == torch.uint8 else np.int32
        arr = np.ascontiguousarray(np.asarray(data, np_dtype))
        if not arr.flags.writeable:      # e.g. np.frombuffer over bytes
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    def applier(self, coeff: np.ndarray) -> ck.ShardApply:
        """The cached ShardApply of a GF(2^8) coefficient matrix."""
        coeff = np.asarray(coeff, np.uint8)
        key = _key(coeff)
        hit = self._appliers.get(key)
        if hit is None:
            hit = ck.ShardApply(coeff)
            self._appliers.put(key, hit)
        return hit

    def install_applier(self, coeff: np.ndarray,
                        applier: ck.ShardApply) -> None:
        """Serve ``coeff`` with a given applier (one built from carried
        kernel constants, see ec.state)."""
        coeff = np.asarray(coeff, np.uint8)
        if (applier.mout, applier.kin) != coeff.shape:
            raise ValueError(f"applier is {applier.mout}x{applier.kin}, "
                             f"matrix is {coeff.shape}")
        self._appliers.put(_key(coeff), applier)

    def grouped_applier(self, coeff: np.ndarray) -> ck.GroupedApply | None:
        """The cached GroupedApply of a sparse matrix, or None when its
        GroupedPlan is not profitable (the matrix then takes the dense
        kernel)."""
        coeff = np.asarray(coeff, np.uint8)
        key = _key(coeff)
        hit = self._grouped.get(key)
        if hit is None:
            plan = ck.GroupedPlan(coeff)
            hit = ck.GroupedApply(plan=plan) if plan.profitable \
                else _NOT_GROUPABLE
            self._grouped.put(key, hit)
        return None if hit is _NOT_GROUPABLE else hit

    def install_grouped(self, coeff: np.ndarray,
                        applier: ck.GroupedApply) -> None:
        """Serve ``coeff`` with a given grouped applier (one built from a
        carried plan, see ec.state)."""
        coeff = np.asarray(coeff, np.uint8)
        if (applier.mout, applier.kin) != coeff.shape:
            raise ValueError(f"applier is {applier.mout}x{applier.kin}, "
                             f"matrix is {coeff.shape}")
        self._grouped.put(_key(coeff), applier)

    def _applier_for(self, coeff: np.ndarray):
        coeff = np.asarray(coeff, np.uint8)
        grouped = self.grouped_applier(coeff)
        return grouped if grouped is not None else self.applier(coeff)

    def apply(self, coeff: np.ndarray, data, out=None) -> torch.Tensor:
        """Apply a GF(2^8) coefficient matrix (m, k) to data (B, k, C) or
        (k, N) uint8, any C or N: the grouped kernels for a sparse repair
        operator, the dense kernels for any other matrix."""
        return self._applier_for(coeff)(self.tensor(data), out)

    def apply_words(self, coeff: np.ndarray, words,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """Word-typed hot path: (k, N4) int32 lanes -> (m, N4) int32, into
        ``out`` when given.  Use cuda_kernels.bytes_to_words/words_to_bytes
        at the boundaries."""
        return self._applier_for(coeff).apply_words(
            self.tensor(words, torch.int32), out)

    def apply_packets(self, BM: np.ndarray, data, w: int) -> torch.Tensor:
        """Apply a RAW GF(2) bitmatrix (rows, k*w) in packet layout to data
        (B, k, C) or (k, C) with C % w == 0 (the bit-schedule code path:
        liberation / blaum_roth / liber8tion / w=16,32 RS).

        An XOR schedule over packets IS a GF(2^8) coefficient matrix with
        entries in {0, 1} acting on packet rows (coefficient 1 = the 8x8
        identity bitmatrix), so the data viewed as (B, k*w, C/w) packet
        rows goes through the same kernels as the GF(2^8) codes."""
        BM = np.asarray(BM, np.uint8)
        data = self.tensor(data)
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        B, k, C = data.shape
        if C % w:
            raise ValueError(f"chunk size {C} not a multiple of w={w}")
        rows = BM.shape[0]
        if rows % w:
            raise ValueError(f"bitmatrix rows {rows} not a multiple of w={w}")
        pkt = C // w
        par = self.applier(BM)(data.reshape(B, k * w, pkt))
        out = par.reshape(B, rows // w, C)
        return out[0] if squeeze else out

    def encode_shards(self, generator: np.ndarray, data) -> torch.Tensor:
        """Systematic shard-layout encode: (k, N) -> (k+m, N).  Chunk row i
        is shard i's contiguous byte stream (the ECUtil stripe layout)."""
        return self.encode(generator, data)

    def encode(self, generator: np.ndarray, data) -> torch.Tensor:
        """Systematic encode: (B, k, C) -> (B, k+m, C) (data || parity), or
        (k, N) -> (k+m, N).  Parity is written in place into the output."""
        k = generator.shape[1]
        data = self.tensor(data)
        shape = list(data.shape)
        shape[-2] = generator.shape[0]
        out = torch.empty(shape, dtype=torch.uint8, device=self.device)
        out[..., :k, :].copy_(data)
        self.apply(generator[k:], data, out=out[..., k:, :])
        return out


_NOT_GROUPABLE = object()

_ENGINES: dict[torch.device, BitplaneEngine] = {}


def default_engine(device=None) -> BitplaneEngine:
    """The process-wide engine of a device (CUDA when None)."""
    dev = resolve_device(device)
    eng = _ENGINES.get(dev)
    if eng is None:
        eng = _ENGINES.setdefault(dev, BitplaneEngine(dev))
    return eng

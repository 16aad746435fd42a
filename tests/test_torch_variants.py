"""The port's encode variants against the JAX package's.

The JAX package selects among five formulations of the dense GF(2) apply
(``ec_pallas_encode_variant``); ``PallasShardApply`` routes each call by
the variant and by whether the matrix needs a blocked contraction.  The
port has a kernel for each (B1, B2, B5a, B5b, B5c), a plain version of
each, and ``cuda_kernels.route``.  Here, on the CPU:

- the gate ``variant_applies`` equals the JAX ``_pick_kblk(kin, mout) ==
  kin`` over a grid on both sides of 32*mout*32*kin = 1 MiB;
- under each variant the port's entries launch the counterpart of the
  kernel the JAX entries launch, for matrices on both sides of the gate
  (the JAX launch functions and the port's wrappers spied);
- each variant's plain version equals its Pallas body run in interpret
  mode, and each variant's entries equal the JAX package and the numpy
  oracle at the geometries of tests/test_pallas.py's variant test.

Tolerance: exact throughout (GF(2) sums of bits).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import matrix as j_matrix
from ceph_tpu.ec import pallas_kernels as pk
from ceph_tpu.ec import reference as j_ref
from ceph_tpu.ec.plugins.jax_rs import ErasureCodeJaxRS as JaxCodec
from ceph_tpu_torch.ec import cuda_kernels as ck

VARIANTS = ("enc_cmp_expand", "enc_u8_expand", "enc_split2", "enc_u8_split2")
GEOMETRIES = [("reed_sol_van", 8, 4), ("cauchy_good", 10, 4),
              ("isa_vandermonde", 8, 3)]


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


class _variants:
    """Both packages under one encode variant, restored on exit."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = (pk.get_encode_variant(), ck.get_encode_variant())
        pk.set_encode_variant(self.name)
        ck.set_encode_variant(self.name)

    def __exit__(self, *exc):
        pk.set_encode_variant(self.prev[0])
        ck.set_encode_variant(self.prev[1])


# -- the gate -------------------------------------------------------------------

KINS = [1, 2, 3, 4, 5, 8, 10, 16, 31, 32, 33, 64, 100, 128, 255, 256, 257,
        512, 1000, 1024, 1025, 2048]


@pytest.mark.parametrize("mout", [1, 2, 3, 4, 8, 16, 31, 32, 33, 64, 128,
                                  256, 1024])
def test_variant_applies_is_the_jax_gate(mout):
    for kin in KINS:
        assert ck.variant_applies(kin, mout) == \
            (pk._pick_kblk(kin, mout) == kin), (kin, mout)


def test_gate_edges():
    assert ck.variant_applies(32, 32)          # mout*kin = 1024
    assert not ck.variant_applies(33, 32)
    assert ck.variant_applies(1024, 1)
    assert not ck.variant_applies(1025, 1)


# -- routes ---------------------------------------------------------------------

# JAX launch function (and variant) -> the port wrapper of its kernel
_JAX_TO_PORT = {
    ("words", None): "gf2_apply_words",
    ("words_variant", "enc_cmp_expand"): "gf2_apply_words_cmp",
    ("words_variant", "enc_split2"): "gf2_apply_words_split2",
    ("u8_variant", "enc_u8_expand"): "gf2_apply_u8",
    ("u8_variant", "enc_u8_split2"): "gf2_apply_u8_split2",
}


def _spy_jax(monkeypatch, seen):
    """Replace the three JAX launch functions with recorders that return
    zeros of the launch's output shape (the route is what is tested)."""
    def words(bm32, w, *, tile, kblk, interpret=False):
        seen.append(_JAX_TO_PORT[("words", None)])
        return jnp.zeros((bm32.shape[0] // 32, w.shape[1]), jnp.int32)

    def words_variant(bm32, w, *, tile, variant, interpret=False):
        seen.append(_JAX_TO_PORT[("words_variant", variant)])
        return jnp.zeros((bm32.shape[0] // 32, w.shape[1]), jnp.int32)

    def u8_variant(bm32, x8, *, tile, variant, interpret=False):
        seen.append(_JAX_TO_PORT[("u8_variant", variant)])
        return jnp.zeros((bm32.shape[0] // 32, 4, x8.shape[2]), jnp.uint8)

    monkeypatch.setattr(pk, "_pallas_apply_words", words)
    monkeypatch.setattr(pk, "_pallas_apply_words_variant", words_variant)
    monkeypatch.setattr(pk, "_pallas_apply_u8_variant", u8_variant)


def _spy_port(monkeypatch, seen):
    """Wrap the port's wrappers (plain versions on the CPU) to record the
    name of each one called."""
    for name, fn in list(ck.KERNELS.items()):
        def spy(*args, _name=name, _fn=fn, **kwargs):
            seen.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setitem(ck.KERNELS, name, spy)


def _packet_w32():
    ec = JaxCodec({"k": "4", "m": "2", "technique": "reed_sol_van",
                   "w": "32"})
    return ec.full_bm[4 * 32:]                       # (64, 128) 0/1


# (label, coefficient matrix, unblocked?)
ROUTE_MATRICES = [
    ("headline_4x8", lambda: j_matrix.generator_matrix(
        "reed_sol_van", 8, 4)[8:], True),
    ("edge_32x32", lambda: _bytes((32, 32), seed=32), True),
    ("packet_w32_64x128", _packet_w32, False),
    ("random_20x60", lambda: _bytes((20, 60), seed=60), False),
]


@pytest.mark.parametrize("variant", ck.ENCODE_VARIANTS)
@pytest.mark.parametrize("label,coeff_fn,unblocked", ROUTE_MATRICES,
                         ids=[m[0] for m in ROUTE_MATRICES])
def test_routes_match_jax(monkeypatch, variant, label, coeff_fn, unblocked):
    coeff = np.asarray(coeff_fn(), np.uint8)
    mout, kin = coeff.shape
    assert ck.variant_applies(kin, mout) == unblocked
    n = 4096
    data = _bytes((kin, n), seed=kin)
    words = data.view(np.int32)
    jseen, pseen = [], []
    _spy_jax(monkeypatch, jseen)
    _spy_port(monkeypatch, pseen)
    jap = pk.PallasShardApply(coeff, interpret=True)
    ap = ck.ShardApply(coeff)
    with _variants(variant):
        jap.apply_words(words)
        jap.apply_bytes(data)
        got_w = ap.apply_words(torch.from_numpy(words.copy()))
        got_b = ap.apply_bytes(torch.from_numpy(data))
        routed = ck.route(kin, mout, n)
        assert ap.route(n) == routed
    assert len(jseen) == 2 and jseen[0] == jseen[1]
    assert pseen == jseen
    assert routed == jseen[0]
    if variant and unblocked:
        assert routed != "gf2_apply_words"           # the variant's kernel
    else:
        assert routed == "gf2_apply_words"           # the production kernel
    want = j_ref.encode(np.vstack([np.eye(kin, dtype=np.uint8), coeff]),
                        data)[kin:]
    assert np.array_equal(got_b.numpy(), want)
    assert np.array_equal(got_w.numpy().view(np.uint8), want)


@pytest.mark.parametrize("variant", ck.ENCODE_VARIANTS)
def test_ragged_length_takes_a_byte_kernel(monkeypatch, variant):
    """A byte length that is not a multiple of 4, which the JAX entry
    refuses, takes B2, or B5c under enc_u8_split2."""
    coeff = j_matrix.generator_matrix("reed_sol_van", 8, 4)[8:]
    data = _bytes((8, 1001), seed=3)
    seen = []
    _spy_port(monkeypatch, seen)
    with _variants(variant):
        with pytest.raises(ValueError):
            pk.PallasShardApply(coeff, interpret=True).apply_bytes(data)
        got = ck.ShardApply(coeff).apply_bytes(torch.from_numpy(data))
    want = "gf2_apply_u8_split2" if variant == "enc_u8_split2" \
        else "gf2_apply_u8"
    assert seen == [want]
    assert np.array_equal(got.numpy(), j_ref.encode(
        j_matrix.generator_matrix("reed_sol_van", 8, 4), data)[8:])


@pytest.mark.parametrize("variant", ck.ENCODE_VARIANTS)
def test_batch_call_routes_as_apply_bytes(monkeypatch, variant):
    """``__call__`` on a (B, k, C) batch launches what apply_bytes would
    for its rows, and a byte kernel reads the batch as it lies."""
    coeff = j_matrix.generator_matrix("cauchy_good", 8, 4)[8:]
    data = _bytes((3, 8, 256), seed=5)
    seen = []
    _spy_port(monkeypatch, seen)
    with _variants(variant):
        got = ck.ShardApply(coeff)(torch.from_numpy(data)).numpy()
        want_route = ck.route(8, 4, 256)
    assert seen == [want_route]
    G = j_matrix.generator_matrix("cauchy_good", 8, 4)
    for b in range(3):
        assert np.array_equal(got[b], j_ref.encode(G, data[b])[8:])


def test_apply_words_out_under_a_u8_variant():
    """A u8 variant's kernel writes apply_words' int32 output through its
    byte view: a caller's ``out`` rows are filled in place."""
    coeff = j_matrix.generator_matrix("reed_sol_van", 8, 4)[8:]
    words = torch.from_numpy(_words((8, 64), seed=8))
    want = ck.gf2_apply_words_plain(
        ck.ShardApply(coeff).consts.plain_bm32(torch.device("cpu")), words)
    for variant in ("enc_u8_expand", "enc_u8_split2"):
        out = torch.zeros((6, 64), dtype=torch.int32)
        with _variants(variant):
            res = ck.ShardApply(coeff).apply_words(words, out=out[2:])
        assert res.data_ptr() == out[2:].data_ptr()
        assert torch.equal(out[2:], want)
        assert not out[:2].any()


@pytest.mark.parametrize("name", ["gf2_apply_words_cmp",
                                  "gf2_apply_words_split2",
                                  "gf2_apply_u8_split2"])
def test_variant_wrappers_refuse_blocked_matrices(name):
    consts = ck.ShardApply(_bytes((20, 60), seed=60)).consts
    dtype = torch.uint8 if name.endswith("u8_split2") else torch.int32
    with pytest.raises(ValueError, match="blocked"):
        ck.KERNELS[name](consts, torch.zeros((60, 16), dtype=dtype))


# -- the bodies -------------------------------------------------------------------

def _coeff(label):
    G = j_matrix.generator_matrix("reed_sol_van", 8, 4)
    if label == "encode":
        return G[8:]
    return j_ref.decode_matrix(G, [4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3])


@pytest.mark.parametrize("matrix", ["encode", "decode_4_erasures"])
@pytest.mark.parametrize("variant,plain", [
    ("enc_cmp_expand", ck.gf2_apply_words_cmp_plain),
    ("enc_split2", ck.gf2_apply_words_split2_plain),
])
def test_word_variant_plain_matches_pallas_body(variant, plain, matrix):
    """The word plain versions against ``_pallas_apply_words_variant`` in
    interpret mode, two tiles of 256 lanes."""
    coeff = _coeff(matrix)
    jap = pk.PallasShardApply(coeff, interpret=True)
    words = _words((8, 512), seed=len(variant))
    expect = np.asarray(pk._pallas_apply_words_variant(
        jnp.asarray(jap.bm32), jnp.asarray(words), tile=256, variant=variant,
        interpret=True))
    consts = ck.ShardApply(coeff).consts
    got = plain(consts.plain_bm32(torch.device("cpu")),
                torch.from_numpy(words))
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("matrix", ["encode", "decode_4_erasures"])
@pytest.mark.parametrize("variant,plain", [
    ("enc_u8_expand", ck.gf2_apply_u8_plain),
    ("enc_u8_split2", ck.gf2_apply_u8_split2_plain),
])
def test_u8_variant_plain_matches_pallas_body(variant, plain, matrix):
    """The byte plain versions against ``_pallas_apply_u8_variant`` in
    interpret mode: the (kin, 4, nq) slot layout is the (kin, 4*nq) stream
    reshaped, so both read and write the same bytes."""
    coeff = _coeff(matrix)
    jap = pk.PallasShardApply(coeff, interpret=True)
    data = _bytes((8, 4 * 512), seed=len(variant))
    out8 = np.asarray(pk._pallas_apply_u8_variant(
        jnp.asarray(jap.bm32), jnp.asarray(data.reshape(8, 4, 512)),
        tile=256, variant=variant, interpret=True))
    consts = ck.ShardApply(coeff).consts
    got = plain(consts.plain_bm(torch.device("cpu")), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), out8.reshape(4, 4 * 512))


@pytest.mark.parametrize("n4", [1, 2, 3, 301])
def test_split2_halves_any_length(n4):
    """The split2 plain versions take any length, odd halves included, and
    agree with the production plain versions."""
    consts = ck.ShardApply(_bytes((32, 32), seed=4)).consts
    cpu = torch.device("cpu")
    words = torch.from_numpy(_words((32, n4), seed=n4))
    assert torch.equal(
        ck.gf2_apply_words_split2_plain(consts.plain_bm32(cpu), words),
        ck.gf2_apply_words_plain(consts.plain_bm32(cpu), words))
    assert torch.equal(
        ck.gf2_apply_words_cmp_plain(consts.plain_bm32(cpu), words),
        ck.gf2_apply_words_plain(consts.plain_bm32(cpu), words))
    data = torch.from_numpy(_bytes((2, 32, n4), seed=n4))
    assert torch.equal(
        ck.gf2_apply_u8_split2_plain(consts.plain_bm(cpu), data),
        ck.gf2_apply_u8_plain(consts.plain_bm(cpu), data))


# -- the entries at the JAX variant test's geometries -------------------------------

@functools.lru_cache(maxsize=None)
def _jax_variant_words(variant, technique, k, m):
    G = j_matrix.generator_matrix(technique, k, m)
    data = _bytes((k, 4096 + 512), seed=k * 31 + m)
    words = np.asarray(pk.bytes_to_words(data))
    with _variants(variant):
        got = np.asarray(
            pk.PallasShardApply(G[k:], interpret=True).apply_words(words))
    return G, data, words, got


@pytest.mark.parametrize("entry", ["apply_words", "apply_bytes"])
@pytest.mark.parametrize("technique,k,m", GEOMETRIES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_bit_identical_to_jax(variant, technique, k, m, entry):
    """tests/test_pallas.py's variant gate, held across packages: under each
    variant the port's entries equal the JAX package's (interpret mode) and
    the numpy oracle, at (k, 4096 + 512) bytes."""
    G, data, words, jax_words = _jax_variant_words(variant, technique, k, m)
    want = j_ref.encode(G, data)[k:]
    assert np.array_equal(jax_words.view(np.uint8), want)
    ap = ck.ShardApply(G[k:])
    with _variants(variant):
        if entry == "apply_words":
            got = ap.apply_words(torch.from_numpy(words.copy())).numpy()
            assert np.array_equal(got, jax_words)
        else:
            got = ap.apply_bytes(torch.from_numpy(data)).numpy()
            assert np.array_equal(got, want)

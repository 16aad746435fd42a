"""The plain reference code: the repository's corpus digests, and every
loss it must rebuild."""

import hashlib
import itertools
import json
import pathlib

import numpy as np
import pytest

from portbench.reference.rs import Code, MUL, generator, invert, apply

CORPUS = pathlib.Path(__file__).resolve().parents[2] / "corpus"


@pytest.mark.parametrize("archive", [
    "jax_rs_k=8_m=4_technique=reed_sol_van.json",
    "jax_rs_k=4_m=2_technique=reed_sol_van.json",
])
def test_corpus_digests(archive):
    d = json.loads((CORPUS / archive).read_text())
    k, m = int(d["profile"]["k"]), int(d["profile"]["m"])
    # the corpus payload: numpy's default_rng(payload_seed) bytes
    payload = np.random.default_rng(d["payload_seed"]).integers(
        0, 256, d["payload_size"], dtype=np.uint8).tobytes()
    shards = Code(k, m, d["chunk_size"]).shards(payload)
    got = {str(i): hashlib.sha256(shards[i].tobytes()).hexdigest()
           for i in range(k + m)}
    assert got == d["chunk_sha256"]


def test_field_tables():
    a = np.arange(256)
    assert (MUL[1] == a).all() and (MUL[:, 1] == a).all()
    assert (MUL == MUL.T).all()
    inv = [next(b for b in range(1, 256) if MUL[x, b] == 1)
           for x in range(1, 256)]
    assert len(set(inv)) == 255


def test_generator_is_systematic_and_mds():
    g = generator(8, 4)
    assert (g[:8] == np.eye(8, dtype=np.uint8)).all()
    for rows in itertools.combinations(range(12), 8):
        sub = g[list(rows)]
        assert (apply(invert(sub), sub) == np.eye(8, dtype=np.uint8)).all()


@pytest.mark.parametrize("lost", range(12))
def test_every_single_loss_decodes(lost):
    code = Code(8, 4, 128)
    payload = np.random.default_rng(lost).bytes(8 * 128 * 5 + 77)
    shards = code.shards(payload)
    have = {i: shards[i] for i in range(12) if i != lost}
    assert (code.decode(have) == shards[:8]).all()
    assert code.object_bytes(code.decode(have), len(payload)) == payload


@pytest.mark.parametrize("lost", [(0, 1, 2, 3), (4, 9, 10, 11),
                                  (8, 9, 10, 11), (0, 5, 7, 10)])
def test_four_losses_decode(lost):
    code = Code(8, 4, 128)
    payload = np.random.default_rng(sum(lost)).bytes(4096)
    shards = code.shards(payload)
    have = {i: shards[i] for i in range(12) if i not in lost}
    assert code.object_bytes(code.decode(have), 4096) == payload


def test_layout_pads_to_whole_stripes():
    code = Code(8, 4, 128)
    data = code.data_shards(b"\x01" * 1500)
    assert data.shape == (8, 256)
    assert code.object_bytes(data, 1500) == b"\x01" * 1500
    assert not data.reshape(8, 2, 128)[:, 1].any() or \
        data.sum() == 1500

"""Bit-exactness check against the repo's erasure-code corpus.

Counterpart of ceph_tpu/ec/corpus.py, ``check`` only: for each archived
(plugin, profile) in ``corpus/*.json`` the port encodes the same
deterministic payload and compares the SHA-256 digest of every chunk with
the archive.  The port never writes the corpus (the JAX package's
``create`` owns it).  Every archive is checked: the port has every plugin
the corpus holds (jax_rs, xor, lrc).

    python -m ceph_tpu_torch.ec.corpus check [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np

from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

CORPUS_DIR = pathlib.Path(__file__).resolve().parents[2] / "corpus"
PAYLOAD_SEED = 0xCE5  # deterministic corpus payload seed
PAYLOAD_SIZE = 31 * 1024 + 17  # deliberately unaligned


def _payload() -> bytes:
    rng = np.random.default_rng(PAYLOAD_SEED)
    return rng.integers(0, 256, PAYLOAD_SIZE, dtype=np.uint8).tobytes()


def _encode_digests(plugin: str, profile: dict[str, str], device) -> dict:
    ec = ErasureCodePluginRegistry().factory(plugin, profile, device=device)
    n = ec.get_chunk_count()
    enc = ec.encode(list(range(n)), _payload())
    return {str(i): hashlib.sha256(enc[i]).hexdigest() for i in range(n)}


def archives(corpus_dir: pathlib.Path = CORPUS_DIR) -> list[pathlib.Path]:
    """Every archive of the corpus, by name."""
    files = sorted(corpus_dir.glob("*.json"))
    if not files:
        raise FileNotFoundError(f"no corpus archives in {corpus_dir}")
    return files


def check(corpus_dir: pathlib.Path = CORPUS_DIR, device=None) -> list[str]:
    """Check every archive on ``device`` (CUDA when None).  Returns the
    list of failures (empty == pass)."""
    failures = []
    for path in archives(corpus_dir):
        rec = json.loads(path.read_text())
        now = _encode_digests(rec["plugin"], rec["profile"], device)
        if now != rec["chunk_sha256"]:
            bad = [i for i in rec["chunk_sha256"]
                   if now.get(i) != rec["chunk_sha256"][i]]
            failures.append(f"{path.name}: chunks {bad} diverged")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cmd", nargs="?", default="check", choices=("check",))
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must exist)")
    args = p.parse_args(argv)
    failures = check(device=args.device)
    for f in failures:
        print(f"FAIL {f}")
    print("corpus: %s (%d archives checked)"
          % ("FAIL" if failures else "OK", len(archives())))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""lrc — layered locally-repairable code.

Counterpart of ceph_tpu/ec/plugins/lrc.py, under the same plugin and
profile name: the kml and layer parsing and the layer logic are the JAX
module's code, and each layer is a port codec (jax_rs by default) built
through the port registry on the LRC's device, so its GF math runs in the
port's kernels.  Host entries take and return numpy; the ``*_device``
entries take and return tensors on the codec's device.

Behavioral mirror of reference src/erasure-code/lrc/ErasureCodeLrc.{h,cc}:

- A code is a stack of *layers*, each a mapping string over the physical
  chunk positions ('D' = data input, 'c' = parity output, other = not in
  layer) plus an inner-plugin profile (ErasureCodeLrc.h:52-61,
  layers_parse ErasureCodeLrc.cc:143, layers_init :213).
- Profiles come in two forms: explicit ``mapping`` + ``layers`` JSON, or
  the generated k/m/l form (parse_kml ErasureCodeLrc.cc:293-397: one
  global layer plus (k+m)/l local layers, each local group l data + 1
  local parity, so chunk_count = k + m + (k+m)/l extra local parities...
  precisely: mapping is regenerated as in the reference).
- ``mapping`` also defines the data→physical remap: data positions first,
  then coding (ErasureCode::to_mapping, reference ErasureCode.cc:274).
- encode runs layers top-down starting from the deepest layer containing
  every requested chunk (ErasureCodeLrc.cc:737-775); decode runs layers
  bottom-up (local layers first — cheap repair), re-using chunks recovered
  by previous layers (ErasureCodeLrc.cc:777-860).
- minimum_to_decode implements the reference's three cases
  (ErasureCodeLrc.cc:566-735): want available → want; layered local
  recovery; full multi-pass recovery with all available chunks.
- create_rule emits the layer-aware CRUSH steps (choose locality /
  chooseleaf failure-domain, ErasureCodeLrc.cc:397-430).

"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.interface import SubChunkRanges
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

# Inner-plugin aliases: reference profiles name CPU plugins; all scalar MDS
# math runs on the port's one engine here.
_PLUGIN_ALIASES = {"jerasure": "jax_rs", "isa": "jax_rs"}
_ISA_TECHNIQUES = {"reed_sol_van": "isa_vandermonde", "cauchy": "isa_cauchy"}


class Layer:
    def __init__(self, chunks_map: str, profile: Mapping[str, str]):
        self.chunks_map = chunks_map
        self.profile = dict(profile)
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_set = frozenset(self.chunks)
        self.code = None  # ErasureCodeInterface, set by layers_init


def _parse_layer_profile(spec) -> dict[str, str]:
    """Second element of a layer entry: dict, JSON object string, or
    space-separated k=v pairs (reference get_json_str_map semantics)."""
    if isinstance(spec, Mapping):
        return {str(k): str(v) for k, v in spec.items()}
    text = str(spec).strip()
    if not text:
        return {}
    if text.startswith("{"):
        return {str(k): str(v) for k, v in json.loads(text).items()}
    out: dict[str, str] = {}
    for token in text.split():
        if "=" not in token:
            raise ValueError(f"layer profile token {token!r} is not k=v")
        key, _, val = token.partition("=")
        out[key] = val
    return out


def _json_relaxed(text: str):
    """json_spirit tolerates trailing commas; strip them before parsing."""
    import re

    return json.loads(re.sub(r",\s*([\]}])", r"\1", text))


class ErasureCodeLrc(ErasureCode):
    def __init__(self, profile: Mapping[str, str] | None = None,
                 device=None):
        super().__init__()
        # the device's engine, for host <-> device conversions (the layers'
        # codecs do the GF math)
        self._engine = default_engine(device)
        self.device = self._engine.device
        self.layers: list[Layer] = []
        self.mapping = ""
        self._chunk_count = 0
        self._data_chunk_count = 0
        self.rule_root = "default"
        self.rule_device_class = ""
        # (op, type, n) steps; default mirrors the constructor
        # (ErasureCodeLrc.h:77-81).
        self.rule_steps: list[tuple[str, str, int]] = [("chooseleaf", "host", 0)]
        if profile is not None:
            self.init(profile)

    # -- profile ---------------------------------------------------------
    def parse(self, profile: Mapping[str, str]) -> None:
        prof = dict(profile)
        self._parse_kml(prof)
        self.rule_root = prof.get("crush-root", "default")
        self.rule_device_class = prof.get("crush-device-class", "")
        if "crush-steps" in prof:
            steps = _json_relaxed(prof["crush-steps"])
            if not isinstance(steps, list):
                raise ValueError("crush-steps must be a JSON array")
            self.rule_steps = []
            for step in steps:
                if not isinstance(step, list) or len(step) < 3:
                    raise ValueError(f"crush-steps entry {step!r} must be [op, type, n]")
                self.rule_steps.append((str(step[0]), str(step[1]), int(step[2])))

        if "mapping" not in prof:
            raise ValueError("the 'mapping' profile parameter is missing")
        if "layers" not in prof:
            raise ValueError("the 'layers' profile parameter is missing")
        self.mapping = prof["mapping"]
        self._data_chunk_count = self.mapping.count("D")
        self._chunk_count = len(self.mapping)
        # to_mapping: data positions first, then coding (ErasureCode.cc:274).
        data_pos = [i for i, c in enumerate(self.mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(self.mapping) if c != "D"]
        self.chunk_mapping = data_pos + coding_pos

        self._layers_parse(prof["layers"])
        self._layers_init()
        self._layers_sanity_checks()

    def _parse_kml(self, prof: dict[str, str]) -> None:
        """Generate mapping/layers/crush steps from k,m,l
        (ErasureCodeLrc.cc:293-397)."""
        k = self.to_int(prof, "k", -1)
        m = self.to_int(prof, "m", -1)
        l = self.to_int(prof, "l", -1)
        if k == -1 and m == -1 and l == -1:
            return
        if -1 in (k, m, l):
            raise ValueError("all of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in prof:
                raise ValueError(
                    f"the {generated} parameter cannot be set when k, m, l are set"
                )
        if l == 0 or (k + m) % l:
            raise ValueError(f"k + m must be a multiple of l (k={k} m={m} l={l})")
        groups = (k + m) // l
        if k % groups:
            raise ValueError(f"k must be a multiple of (k + m) / l (k={k} l={l})")
        if m % groups:
            raise ValueError(f"m must be a multiple of (k + m) / l (m={m} l={l})")
        kg, mg = k // groups, m // groups
        prof["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = []
        # Global layer covers every group's data and global parities.
        layers.append([("D" * kg + "c" * mg + "_") * groups, ""])
        # One local layer per group: l inputs (data + global parity) + 1
        # local parity.
        for i in range(groups):
            row = "".join(
                ("D" * l + "c") if i == j else "_" * (l + 1) for j in range(groups)
            )
            layers.append([row, ""])
        prof["layers"] = json.dumps(layers)

        locality = prof.get("crush-locality", "")
        failure_domain = prof.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [
                ("choose", locality, groups),
                ("chooseleaf", failure_domain, l + 1),
            ]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    def _layers_parse(self, description: str) -> None:
        layers_json = _json_relaxed(description)
        if not isinstance(layers_json, list):
            raise ValueError(f"layers {description!r} must be a JSON array")
        self.layers = []
        for entry in layers_json:
            if not isinstance(entry, list) or not entry:
                raise ValueError(f"layer entry {entry!r} must be a non-empty array")
            chunks_map = entry[0]
            if not isinstance(chunks_map, str):
                raise ValueError(f"layer mapping {chunks_map!r} must be a string")
            layer_profile = _parse_layer_profile(entry[1]) if len(entry) > 1 else {}
            self.layers.append(Layer(chunks_map, layer_profile))

    def _layers_init(self) -> None:
        registry = ErasureCodePluginRegistry.instance()
        for layer in self.layers:
            prof = dict(layer.profile)
            prof.setdefault("k", str(len(layer.data)))
            prof.setdefault("m", str(len(layer.coding)))
            plugin = _PLUGIN_ALIASES.get(
                prof.get("plugin", "jax_rs"), prof.get("plugin", "jax_rs")
            )
            technique = prof.get("technique", "reed_sol_van")
            if prof.get("plugin") == "isa":
                technique = _ISA_TECHNIQUES.get(technique, technique)
            prof["plugin"] = plugin
            prof["technique"] = technique
            inner = {k: v for k, v in prof.items() if k != "plugin"}
            layer.code = registry.factory(plugin, inner,
                                          device=self.device)

    def _layers_sanity_checks(self) -> None:
        if not self.layers:
            raise ValueError("layers parameter must have at least one layer")
        for pos, layer in enumerate(self.layers):
            if len(layer.chunks_map) != self._chunk_count:
                raise ValueError(
                    f"layer {pos} mapping {layer.chunks_map!r} is "
                    f"{len(layer.chunks_map)} characters long, expected "
                    f"{self._chunk_count} (the length of {self.mapping!r})"
                )

    # -- geometry --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self._data_chunk_count

    def get_chunk_size(self, object_size: int) -> int:
        # Delegate to the first (global) layer (ErasureCodeLrc.cc:559-563);
        # its k equals the whole code's data chunk count.
        return self.layers[0].code.get_chunk_size(object_size)

    # -- encode ----------------------------------------------------------
    def encode_chunks(self, data_chunks) -> np.ndarray:
        """(k, C) logical data -> (chunk_count, C) physical stripe."""
        data = np.asarray(data_chunks, np.uint8)
        k, width = data.shape
        if k != self._data_chunk_count:
            raise ValueError(f"expected {self._data_chunk_count} data chunks, got {k}")
        phys = np.zeros((self._chunk_count, width), np.uint8)
        for logical, position in enumerate(self.chunk_mapping[:k]):
            phys[position] = data[logical]
        self._encode_layers(phys, range(self._chunk_count))
        return phys

    def _encode_layers(self, phys: np.ndarray, want_to_encode) -> None:
        """Run layer encodes in place (ErasureCodeLrc.cc:737-775)."""
        want = set(int(i) for i in want_to_encode)
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want <= layer.chunks_set:
                break
        for layer in self.layers[top:]:
            stacked = np.stack([phys[c] for c in layer.data])
            encoded = np.asarray(layer.code.encode_chunks(stacked))
            for local, c in enumerate(layer.chunks):
                phys[c] = encoded[local]

    def encode(self, want_to_encode: Sequence[int], data: bytes) -> dict[int, bytes]:
        phys = self.encode_chunks(self.encode_prepare(data))
        # want_to_encode addresses *physical* chunk ids, as in the
        # reference's encode_chunks(want_to_encode, encoded).
        return {int(i): phys[int(i)].tobytes() for i in want_to_encode}

    # -- decode ----------------------------------------------------------
    def decode_chunks(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        erasures = {
            i for i in range(self._chunk_count) if i not in avail
        }
        decoded: dict[int, np.ndarray] = dict(avail)
        want_erasures = erasures & set(want)
        # Bottom-up: local layers first, re-using recovered chunks
        # (ErasureCodeLrc.cc:777-860). Unlike the reference's single
        # reverse pass, iterate to a fixpoint: a global-layer recovery can
        # unlock a local layer that was skipped earlier (e.g. data chunk +
        # its local parity both lost), so strictly more erasure patterns
        # are recoverable.
        progress = True
        while want_erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) > len(layer.coding):
                    continue  # too many erasures for this layer
                layer_chunks = {
                    local: decoded[c]
                    for local, c in enumerate(layer.chunks)
                    if c not in erasures
                }
                layer_want = [
                    local
                    for local, c in enumerate(layer.chunks)
                    if c in layer_erasures
                ]
                layer_out = layer.code.decode_chunks(layer_chunks, layer_want)
                for local, c in enumerate(layer.chunks):
                    if local in layer_out:
                        decoded[c] = np.asarray(layer_out[local], np.uint8)
                    erasures.discard(c)
                progress = True
                want_erasures = erasures & set(want)
                if not want_erasures:
                    break
        if want_erasures:
            raise IOError(
                f"cannot read {sorted(want_erasures)} with available "
                f"{sorted(avail)}"
            )
        return {w: decoded[w] for w in want}

    # -- batched paths (the ECBackend hot-path duck-type) ----------------
    def encode_chunks_batch(self, data) -> np.ndarray:
        """(B, k, C) -> (B, chunk_count, C); host arrays in and out."""
        return self.encode_chunks_device(np.asarray(data)).cpu().numpy()

    def decode_chunks_batch(
        self, available: Mapping[int, np.ndarray], want_to_read: Sequence[int]
    ) -> dict[int, np.ndarray]:
        """Batched reconstruct: available chunks are (B, C) arrays."""
        want = [int(w) for w in want_to_read]
        avail = {int(i): np.asarray(c, np.uint8) for i, c in available.items()}
        missing = [w for w in want if w not in avail]
        out = {w: avail[w] for w in want if w in avail}
        if missing:
            rebuilt = self.decode_chunks_device(avail, missing).cpu().numpy()
            for slot, w in enumerate(missing):
                out[w] = rebuilt[:, slot]
        return out

    # -- device-batched paths -------------------------------------------
    def encode_chunks_device(self, data) -> torch.Tensor:
        """(B, k, C) -> (B, chunk_count, C) tensor on the codec's device.

        Layered encode on the device: scatter data to physical positions,
        then run each layer's inner device encode and scatter its outputs
        back (the batched analog of ErasureCodeLrc encode_chunks)."""
        data = self._engine.tensor(data)
        B, k, C = data.shape
        phys = torch.zeros((B, self._chunk_count, C), dtype=torch.uint8,
                           device=self.device)
        phys[:, self.chunk_mapping[:k]] = data
        for layer in self.layers:
            encoded = layer.code.encode_chunks_device(phys[:, layer.data])
            phys[:, layer.chunks] = encoded
        return phys

    def decode_chunks_device(self, available, want_to_read) -> torch.Tensor:
        """Batched layered reconstruct: available maps chunk id -> (B, C)
        tensors; returns (B, len(want), C)."""
        decoded = {int(i): self._engine.tensor(c)
                   for i, c in available.items()}
        want = [int(w) for w in want_to_read]
        erasures = {i for i in range(self._chunk_count) if i not in decoded}
        want_erasures = erasures & set(want)
        progress = True
        while want_erasures and progress:  # fixpoint, as in decode_chunks
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & erasures
                if not layer_erasures or len(layer_erasures) > len(layer.coding):
                    continue
                layer_avail = {
                    local: decoded[c]
                    for local, c in enumerate(layer.chunks)
                    if c not in erasures
                }
                layer_want = [
                    local
                    for local, c in enumerate(layer.chunks)
                    if c in layer_erasures
                ]
                rebuilt = layer.code.decode_chunks_device(layer_avail, layer_want)
                for slot, local in enumerate(layer_want):
                    decoded[layer.chunks[local]] = rebuilt[:, slot]
                erasures -= layer.chunks_set
                progress = True
                want_erasures = erasures & set(want)
                if not want_erasures:
                    break
        if want_erasures:
            raise IOError(f"cannot read {sorted(want_erasures)}")
        return torch.stack([decoded[w] for w in want], dim=1)

    # -- minimum_to_decode ----------------------------------------------
    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> dict[int, SubChunkRanges]:
        want = set(int(w) for w in want_to_read)
        avail = set(int(a) for a in available)
        minimum = self._minimum_to_decode(want, avail)
        return self._default_ranges(sorted(minimum))

    def _minimum_to_decode(self, want: set[int], avail: set[int]) -> set[int]:
        """Three-case strategy of ErasureCodeLrc.cc:566-735."""
        all_chunks = set(range(self._chunk_count))
        erasures_total = all_chunks - avail
        erasures_want = want & erasures_total

        # Case 1: nothing we want is missing.
        if not erasures_want:
            return set(want)

        # Case 2: recover wanted erasures with as few chunks as possible,
        # local (later) layers first.
        minimum: set[int] = set()
        erasures_not_recovered = set(erasures_total)
        remaining_want_erasures = set(erasures_want)
        for layer in reversed(self.layers):
            layer_want = want & layer.chunks_set
            if not layer_want:
                continue
            layer_erasures = layer_want & remaining_want_erasures
            if not layer_erasures:
                layer_minimum = set(layer_want)
            else:
                erased_in_layer = layer.chunks_set & erasures_not_recovered
                if len(erased_in_layer) > len(layer.coding):
                    continue  # hope an upper layer does better
                layer_minimum = layer.chunks_set - erasures_not_recovered
                erasures_not_recovered -= erased_in_layer
                remaining_want_erasures -= erased_in_layer
            minimum |= layer_minimum
        if not remaining_want_erasures:
            minimum |= want
            minimum -= erasures_total
            return minimum

        # Case 3: multi-pass — recover everything recoverable, layer by
        # layer, and read all available chunks. Iterated to a fixpoint
        # (matching decode_chunks), which recovers strictly more patterns
        # than the reference's single reverse pass.
        erasures = set(erasures_total)
        progress = True
        while erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) <= len(layer.coding):
                    erasures -= layer_erasures
                    progress = True
        if not erasures:
            return set(avail)

        raise IOError(
            f"not enough chunks in {sorted(avail)} to read {sorted(want)}"
        )

    # -- placement -------------------------------------------------------
    def create_rule(self, name: str, crush) -> int:
        """Layer-aware rule: explicit steps when configured
        (ErasureCodeLrc.cc create_rule with rule_steps)."""
        return crush.create_ec_rule(
            name,
            chunk_count=self.get_chunk_count(),
            failure_domain=self.rule_steps[-1][1],
            root=self.rule_root,
            device_class=self.rule_device_class,
            steps=list(self.rule_steps),
        )


def __erasure_code_init__(registry: ErasureCodePluginRegistry) -> None:
    registry.add("lrc", ErasureCodeLrc)

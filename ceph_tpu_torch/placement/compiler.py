"""CRUSH map text compiler/decompiler.

Counterpart of ceph_tpu/placement/compiler.py: the same module over the
port's imports.

The role of reference src/crush/CrushCompiler.{h,cc} (crushtool -d /
-c): render a CrushMap as the canonical editable text form and parse
that form back, round-tripping every feature our map model supports
(tunables, types, devices, all bucket algs, weight-set choose_args,
firstn/indep rules).  Grammar follows the reference's map file format:

    tunable <name> <value>
    device <id> osd.<id> [class <name>]
    type <id> <name>
    <type> <name> {
        id <negative-id>
        alg straw2|uniform|list|tree
        item <name-or-osd.N> weight <float>
    }
    rule <name> {
        id <n>
        type replicated|erasure
        step take <bucket> [class <name>]
        step choose|chooseleaf firstn|indep <n> type <type>
        step emit
    }
"""

from __future__ import annotations

from ceph_tpu_torch.placement.crush_map import Bucket, CrushMap, Rule, Tunables

_TUNABLES = (
    "choose_total_tries", "choose_local_retries",
    "choose_local_fallback_retries", "chooseleaf_descend_once",
    "chooseleaf_vary_r", "chooseleaf_stable",
)


class CompileError(ValueError):
    pass


# -- decompile --------------------------------------------------------------

def decompile(m: CrushMap) -> str:
    out = ["# begin crush map"]
    for name in _TUNABLES:
        out.append(f"tunable {name} {int(getattr(m.tunables, name))}")
    out.append("")
    out.append("# devices")
    for dev in sorted(_devices_in_use(m)):
        cls = m.class_map.get(dev)
        suffix = f" class {cls}" if cls else ""
        out.append(f"device {dev} osd.{dev}{suffix}")
    out.append("")
    out.append("# types")
    for tname, tid in sorted(m.types.items(), key=lambda kv: kv[1]):
        out.append(f"type {tid} {tname}")
    out.append("")
    out.append("# buckets")
    type_names = {tid: tname for tname, tid in m.types.items()}
    # children before parents so the compiler sees references resolved
    ordered: list = []
    emitted: set[int] = set()

    def emit(b) -> None:
        if b.id in emitted:
            return
        emitted.add(b.id)
        for item in b.items:
            if item < 0:
                emit(m.buckets[item])
        ordered.append(b)

    for b in sorted(m.buckets.values(), key=lambda b: b.id,
                    reverse=True):
        if m.is_shadow(b.id):
            continue                # derived "~class" trees never print
        emit(b)
    for b in ordered:
        out.append(f"{type_names[b.type_id]} {b.name} {{")
        out.append(f"\tid {b.id}")
        # persistent shadow ids (reference crushtool "id -N class ..."):
        # they feed draw hashes, so the text form must round-trip them
        for cls, sid in sorted(m.class_bucket.get(b.id, {}).items()):
            out.append(f"\tid {sid} class {cls}")
        out.append(f"\talg {b.alg}")
        for item, w in zip(b.items, b.weights):
            iname = (f"osd.{item}" if item >= 0
                     else m.buckets[item].name)
            out.append(f"\titem {iname} weight {w / 0x10000:.5f}")
        out.append("}")
        out.append("")
    out.append("# rules")
    for r in sorted(m.rules.values(), key=lambda r: r.rule_id):
        out.append(f"rule {r.name} {{")
        out.append(f"\tid {r.rule_id}")
        kind = ("erasure" if any("indep" in s[0] for s in r.steps)
                else "replicated")
        out.append(f"\ttype {kind}")
        for step in r.steps:
            if step[0] == "take":
                cls = step[2] if len(step) > 2 and step[2] else ""
                out.append(f"\tstep take {step[1]}"
                           + (f" class {cls}" if cls else ""))
            elif step[0] == "emit":
                out.append("\tstep emit")
            else:
                op, mode = step[0].split("_")
                out.append(
                    f"\tstep {op} {mode} {step[1]} type {step[2]}"
                )
        out.append("}")
        out.append("")
    for name, per_bucket in sorted(m.choose_args.items()):
        out.append(f"choose_args {name} {{")
        for bid, ws in sorted(per_bucket.items(), reverse=True):
            if m.is_shadow(bid):
                continue
            ws_txt = " ".join(f"{w / 0x10000:.5f}" for w in ws)
            out.append(f"\tbucket {m.buckets[bid].name} weights {ws_txt}")
        out.append("}")
        out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def _devices_in_use(m: CrushMap) -> set[int]:
    # classed-but-bucketless devices must still print, or their class
    # assignment would vanish on a getcrushmap/setcrushmap round trip
    return {i for b in m.buckets.values()
            for i in b.items if i >= 0} | set(m.class_map)


# -- compile ----------------------------------------------------------------

def compile_text(text: str) -> CrushMap:
    """Parse the text form back into a CrushMap."""
    lines = [
        ln.strip() for ln in text.splitlines()
        if ln.strip() and not ln.strip().startswith("#")
    ]
    tunables = Tunables()
    types: dict[int, str] = {}
    device_classes: dict[int, str] = {}
    bucket_blocks: list[tuple[str, str, list[list[str]]]] = []
    rule_blocks: list[tuple[str, list[list[str]]]] = []
    ca_blocks: list[tuple[str, list[list[str]]]] = []
    i = 0
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] == "tunable":
            if len(tok) != 3 or tok[1] not in _TUNABLES:
                raise CompileError(f"bad tunable line: {lines[i]!r}")
            if tok[1] == "chooseleaf_descend_once":
                setattr(tunables, tok[1], tok[2] != "0")
            else:
                setattr(tunables, tok[1], int(tok[2]))
            i += 1
        elif tok[0] == "device":
            # devices are implied by bucket items; only class sticks
            if len(tok) >= 5 and tok[3] == "class":
                device_classes[int(tok[1])] = tok[4]
            i += 1
        elif tok[0] == "type":
            if len(tok) != 3:
                raise CompileError(f"bad type line: {lines[i]!r}")
            types[int(tok[1])] = tok[2]
            i += 1
        elif tok[0] == "rule":
            name, body, i = _read_block(lines, i, 1)
            rule_blocks.append((name, body))
        elif tok[0] == "choose_args":
            name, body, i = _read_block(lines, i, 1)
            ca_blocks.append((name, body))
        elif len(tok) >= 3 and tok[2] == "{":
            name, body, i = _read_block(lines, i, 1)
            bucket_blocks.append((tok[0], name, body))
        else:
            raise CompileError(f"unrecognized line: {lines[i]!r}")

    m = CrushMap(tunables)
    for tid, tname in sorted(types.items()):
        if tname not in m.types:
            m.types[tname] = tid
        elif m.types[tname] != tid:
            raise CompileError(
                f"type {tname!r} id {tid} conflicts with {m.types[tname]}"
            )
    for type_name, name, body in bucket_blocks:
        _compile_bucket(m, type_name, name, body)
    for dev, cls in device_classes.items():
        m.set_item_class(dev, cls)
    for name, body in rule_blocks:
        _compile_rule(m, name, body)
    for name, body in ca_blocks:
        _compile_choose_args(m, name, body)
    return m


def _read_block(lines: list[str], i: int,
                name_tok: int) -> tuple[str, list[list[str]], int]:
    head = lines[i].split()
    if head[-1] != "{":
        raise CompileError(f"expected '{{' on: {lines[i]!r}")
    name = head[name_tok]
    body: list[list[str]] = []
    i += 1
    while i < len(lines) and lines[i] != "}":
        body.append(lines[i].split())
        i += 1
    if i >= len(lines):
        raise CompileError(f"unterminated block for {name!r}")
    return name, body, i + 1


def _compile_bucket(m: CrushMap, type_name: str, name: str,
                    body: list[list[str]]) -> None:
    if type_name not in m.types:
        raise CompileError(f"bucket {name!r}: unknown type {type_name!r}")
    bid = None
    alg = "straw2"
    items: list[tuple[str, float | None]] = []
    class_ids: dict[str, int] = {}
    for tok in body:
        if tok[0] == "id":
            if len(tok) >= 4 and tok[2] == "class":
                class_ids[tok[3]] = int(tok[1])
            else:
                bid = int(tok[1])
        elif tok[0] == "alg":
            if tok[1] not in ("straw2", "uniform", "list", "tree"):
                raise CompileError(f"bucket {name!r}: bad alg {tok[1]!r}")
            alg = tok[1]
        elif tok[0] == "hash":
            pass                    # rjenkins1 is the only hash we speak
        elif tok[0] == "item":
            w = None
            if len(tok) >= 4 and tok[2] == "weight":
                w = float(tok[3])
            items.append((tok[1], w))
        else:
            raise CompileError(f"bucket {name!r}: bad line {tok!r}")
    b = m.add_bucket(name, type_name, alg)
    if bid is not None:
        # honor the declared id so rules/choose_args can reference it
        del m.buckets[b.id]
        if bid in m.buckets:
            raise CompileError(f"duplicate bucket id {bid}")
        b = Bucket(bid, b.type_id, b.name, b.alg)
        m.buckets[bid] = b
        m.names[name] = bid
        m._next_bucket_id = min(m._next_bucket_id, bid - 1)
    if class_ids:
        m.class_bucket[b.id] = class_ids
        m._next_bucket_id = min(
            [m._next_bucket_id] + [s - 1 for s in class_ids.values()])
    for iname, w in items:
        if iname.startswith("osd."):
            m.add_item(b, int(iname[4:]), w)
        else:
            if iname not in m.names:
                raise CompileError(
                    f"bucket {name!r}: child {iname!r} not yet defined"
                )
            m.add_item(b, m.buckets[m.names[iname]], w)


def _compile_rule(m: CrushMap, name: str, body: list[list[str]]) -> None:
    rule_id = -1
    steps: list[tuple] = []
    for tok in body:
        if tok[0] == "id":
            rule_id = int(tok[1])
        elif tok[0] == "type":
            pass                    # informative; op mode encodes it
        elif tok[0] == "step":
            if tok[1] == "take":
                if len(tok) >= 5 and tok[3] == "class":
                    steps.append(("take", tok[2], tok[4]))
                elif len(tok) == 3:
                    steps.append(("take", tok[2]))
                else:
                    raise CompileError(
                        f"rule {name!r}: bad step {tok!r}")
            elif tok[1] == "emit":
                steps.append(("emit",))
            elif tok[1] in ("choose", "chooseleaf"):
                # step choose firstn N type host
                if len(tok) != 6 or tok[2] not in ("firstn", "indep") \
                        or tok[4] != "type":
                    raise CompileError(f"rule {name!r}: bad step {tok!r}")
                steps.append((f"{tok[1]}_{tok[2]}", int(tok[3]), tok[5]))
            else:
                raise CompileError(f"rule {name!r}: bad step {tok!r}")
        else:
            raise CompileError(f"rule {name!r}: bad line {tok!r}")
    if not steps or steps[0][0] != "take" or steps[-1][0] != "emit":
        raise CompileError(f"rule {name!r}: must be take ... emit")
    m.add_rule(Rule(name, steps, rule_id))


def _compile_choose_args(m: CrushMap, name: str,
                         body: list[list[str]]) -> None:
    per_bucket: dict[int, list[int]] = {}
    for tok in body:
        if tok[0] != "bucket" or tok[2] != "weights":
            raise CompileError(f"choose_args {name!r}: bad line {tok!r}")
        if tok[1] not in m.names:
            raise CompileError(
                f"choose_args {name!r}: unknown bucket {tok[1]!r}"
            )
        bid = m.names[tok[1]]
        ws = [int(round(float(w) * 0x10000)) for w in tok[3:]]
        if len(ws) != len(m.buckets[bid].items):
            raise CompileError(
                f"choose_args {name!r}: bucket {tok[1]!r} wants "
                f"{len(m.buckets[bid].items)} weights, got {len(ws)}"
            )
        per_bucket[bid] = ws
    m.choose_args[name] = per_bucket

"""CRUSH map model + rule evaluation.

Counterpart of ceph_tpu/placement/crush_map.py: the same module over the
port's imports.

The map/rule data model of reference src/crush/crush.h + CrushWrapper.h,
with the rule-step machine of crush_do_rule (mapper.c:900), choose_firstn
(:461) and choose_indep (:650) — reimplemented as explicit Python state with
straw2 draws vectorized per bucket. Tunables default to the reference's
modern profile (choose_total_tries=50, chooseleaf_descend_once/vary_r/stable
on, local retries off).

Buckets are straw2 (the modern default; reference deprecates straw),
uniform (equal weights), list (sequential weighted draw — cheap adds at
the head, reference crush.h CRUSH_BUCKET_LIST), or tree (log-depth
weighted binary descent, CRUSH_BUCKET_TREE).  list/tree follow the
published algorithms over our own layout (implicit heap for tree) and
are not bit-compatible with upstream's node numbering — legacy algs
kept for API parity; straw2 is the placement-stable choice and IS
bit-compatible.  Device ids >= 0; bucket ids < 0.

choose_args (CrushWrapper choose_args / weight-sets): named alternative
per-bucket weight vectors consulted during bucket draws, letting a
balancer skew placement without touching the real hierarchy weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ceph_tpu_torch.placement.hashing import crush_hash32_2, crush_hash32_4
from ceph_tpu_torch.placement.straw2 import straw2_draws

ITEM_NONE = 0x7FFFFFFF  # CRUSH_ITEM_NONE: indep hole marker
DEVICE_TYPE = 0


@dataclass
class Tunables:
    """mapper.c tunables, modern ("jewel"+) defaults."""

    choose_total_tries: int = 50
    choose_local_retries: int = 0
    choose_local_fallback_retries: int = 0
    chooseleaf_descend_once: bool = True
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


@dataclass
class Bucket:
    id: int
    type_id: int
    name: str
    alg: str = "straw2"
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)  # 16.16 fixed point

    @property
    def weight(self) -> int:
        return sum(self.weights)


@dataclass
class Rule:
    name: str
    steps: list[tuple]
    rule_id: int = -1
    # step forms:
    #   ("take", bucket_name[, device_class])
    #   ("choose_firstn" | "chooseleaf_firstn" |
    #    "choose_indep"  | "chooseleaf_indep", num, type_name)
    #   ("emit",)


def weight_to_fp(w: float) -> int:
    return int(round(w * 0x10000))


class CrushMap:
    def __init__(self, tunables: Tunables | None = None):
        self.tunables = tunables or Tunables()
        self.types: dict[str, int] = {"osd": DEVICE_TYPE}
        self.buckets: dict[int, Bucket] = {}
        self.names: dict[str, int] = {}
        self.rules: dict[str, Rule] = {}
        self.max_device = 0
        self._next_bucket_id = -1
        self._parent: dict[int, int] = {}  # child bucket id -> parent id
        # weight-set name -> bucket id -> alternative weights (16.16)
        self.choose_args: dict[str, dict[int, list[int]]] = {}
        self._active_weights: dict[int, list[int]] | None = None
        self._tree_heap_cache: dict[tuple, tuple[list[int], int]] = {}
        # device classes (CrushWrapper.h:68 class_map; :458 shadow trees)
        self.class_map: dict[int, str] = {}     # device id -> class name
        # orig bucket id -> class -> shadow bucket id.  PERSISTENT (like
        # the reference's class_bucket): shadow ids feed the draw hashes
        # through parent items, so they must survive rebuilds and
        # serialization or class-restricted placement would reshuffle.
        self.class_bucket: dict[int, dict[str, int]] = {}
        self._shadow_ids: set[int] = set()      # derived shadow buckets
        self._shadow_gen: dict[int, int] = {}   # shadow id -> gen built
        self._topo_gen = 0                      # bumped on any topo edit

    # -- construction (builder.c / CrushWrapper facade) ------------------
    def add_type(self, name: str) -> int:
        if name not in self.types:
            self.types[name] = max(self.types.values()) + 1
        return self.types[name]

    def add_bucket(
        self, name: str, type_name: str, alg: str = "straw2"
    ) -> Bucket:
        if name in self.names:
            raise ValueError(f"bucket {name!r} exists")
        bid = self._next_bucket_id
        self._next_bucket_id -= 1
        b = Bucket(bid, self.add_type(type_name), name, alg)
        self.buckets[bid] = b
        self.names[name] = bid
        self._topo_gen += 1
        return b

    def add_item(self, bucket: Bucket | str, item: int | Bucket,
                 weight: float | None = None) -> None:
        """Add a device id or child bucket to a bucket. Child buckets
        default to their subtree weight, and weight changes cascade up the
        tree (CrushWrapper::insert_item / adjust_item_weight semantics) so
        construction order cannot silently zero out a subtree."""
        if isinstance(bucket, str):
            bucket = self.buckets[self.names[bucket]]
        if isinstance(item, Bucket):
            item_id = item.id
            w = item.weight if weight is None else weight_to_fp(weight)
            self._parent[item_id] = bucket.id
        else:
            item_id = int(item)
            if item_id < 0:
                raise ValueError("device ids must be >= 0")
            w = weight_to_fp(1.0 if weight is None else weight)
            self.max_device = max(self.max_device, item_id + 1)
        bucket.items.append(item_id)
        bucket.weights.append(w)
        self._propagate_weight(bucket)
        self._topo_gen += 1

    def _propagate_weight(self, bucket: Bucket) -> None:
        """Refresh ancestors' stored weight for ``bucket`` subtrees."""
        child = bucket
        while child.id in self._parent:
            parent = self.buckets[self._parent[child.id]]
            idx = parent.items.index(child.id)
            parent.weights[idx] = child.weight
            child = parent

    def remove_item(self, item_id: int) -> bool:
        """Remove a device from whichever bucket holds it
        (CrushWrapper::remove_item role, the ``osd purge`` CRUSH half).
        The emptied host bucket stays — removing a drained OSD must
        not reshuffle sibling hosts' straw draws.  Returns False when
        the device is in no bucket."""
        if item_id < 0:
            raise ValueError("remove_item removes devices, not buckets")
        found = False
        for b in self.buckets.values():
            if b.id in self._shadow_ids or item_id not in b.items:
                continue
            idx = b.items.index(item_id)
            b.items.pop(idx)
            b.weights.pop(idx)
            self._propagate_weight(b)
            found = True
        if found:
            self.class_map.pop(item_id, None)
            self._topo_gen += 1
        return found

    # -- device classes (CrushWrapper.h:68,458 class-shadow trees) --------
    def set_item_class(self, device_id: int, class_name: str) -> None:
        """Assign a device class (``osd crush set-device-class``,
        CrushWrapper::set_item_class).  Empty name removes the class."""
        if device_id < 0:
            raise ValueError("classes apply to devices, not buckets")
        if class_name:
            self.class_map[device_id] = str(class_name)
        else:
            self.class_map.pop(device_id, None)
        self._topo_gen += 1

    def get_item_class(self, device_id: int) -> str | None:
        return self.class_map.get(device_id)

    def class_devices(self, class_name: str) -> list[int]:
        return sorted(d for d, c in self.class_map.items()
                      if c == class_name)

    def device_classes(self) -> list[str]:
        return sorted(set(self.class_map.values()))

    def is_shadow(self, bucket_id: int) -> bool:
        return bucket_id in self._shadow_ids

    def _class_shadow(self, bucket: Bucket, cls: str) -> Bucket | None:
        """The class-filtered shadow of ``bucket`` (reference
        CrushWrapper.h:458 class_bucket / "~class" trees): same shape,
        only devices of ``cls`` kept, empty subtrees pruned, weights the
        filtered subtree sums.  Shadows are derived state — rebuilt
        lazily whenever the real topology or class_map changed, never
        serialized.  Returns None when the subtree holds no such device.
        """
        name = f"{bucket.name}~{cls}"
        sid = self.class_bucket.get(bucket.id, {}).get(cls)
        if sid is not None and self._shadow_gen.get(sid) == self._topo_gen:
            return self.buckets[sid]
        items: list[int] = []
        weights: list[int] = []
        positions: list[int] = []       # original item positions kept
        for pos, (item, w) in enumerate(zip(bucket.items, bucket.weights)):
            if item >= 0:
                if self.class_map.get(item) == cls:
                    items.append(item)
                    weights.append(w)
                    positions.append(pos)
            else:
                sub = self._class_shadow(self.buckets[item], cls)
                if sub is not None:
                    items.append(sub.id)
                    weights.append(sub.weight)
                    positions.append(pos)
        if sid is not None:
            self._drop_shadow(sid)
        if not items:
            return None
        if sid is None:
            sid = self._next_bucket_id
            self._next_bucket_id -= 1
            self.class_bucket.setdefault(bucket.id, {})[cls] = sid
        sb = Bucket(sid, bucket.type_id, name, bucket.alg, items, weights)
        self.buckets[sid] = sb
        self.names[name] = sid
        self._shadow_ids.add(sid)
        self._shadow_gen[sid] = self._topo_gen
        # project weight-sets onto the kept positions so the balancer's
        # choose_args steer class-restricted draws too: device positions
        # keep their override weight, child positions use the shadow
        # child's filtered weight (CrushWrapper choose_args size path)
        for per_bucket in self.choose_args.values():
            override = per_bucket.get(bucket.id)
            if override is None or len(override) != len(bucket.items):
                continue
            per_bucket[sid] = [
                override[p] if bucket.items[p] >= 0 else weights[j]
                for j, p in enumerate(positions)
            ]
        return sb

    def _drop_shadow(self, sid: int) -> None:
        b = self.buckets.pop(sid, None)
        if b is not None and self.names.get(b.name) == sid:
            del self.names[b.name]
        self._shadow_ids.discard(sid)
        self._shadow_gen.pop(sid, None)
        for per_bucket in self.choose_args.values():
            per_bucket.pop(sid, None)

    def add_rule(self, rule: Rule) -> Rule:
        rule.rule_id = len(self.rules) if rule.rule_id < 0 else rule.rule_id
        self.rules[rule.name] = rule
        return rule

    def create_replicated_rule(
        self, name: str, failure_domain: str = "host",
        root: str = "default", device_class: str = "",
    ) -> Rule:
        take = (("take", root, device_class) if device_class
                else ("take", root))
        return self.add_rule(Rule(name, [
            take,
            ("chooseleaf_firstn", 0, failure_domain),
            ("emit",),
        ]))

    def create_ec_rule(
        self,
        name: str,
        chunk_count: int,
        failure_domain: str = "host",
        root: str = "default",
        device_class: str = "",
        steps=None,
    ) -> Rule:
        """EC rules use indep (holes allowed, positions stable) —
        ErasureCodeInterface.h:212 / ErasureCode::create_rule semantics.

        ``steps``: optional explicit (op, type, n) triples — the LRC
        layered-rule form (reference ErasureCodeLrc.cc parse_rule_step),
        with op in {"choose", "chooseleaf"} — translated to indep ops.

        ``device_class``: restrict placement to devices of that class by
        taking the class-shadow tree (OSDMonitor.cc:9891
        ``erasure-code-profile set … crush-device-class``)."""
        take = (("take", root, device_class) if device_class
                else ("take", root))
        if steps:
            rule_steps = [take]
            for op, type_name, n in steps:
                if op not in ("choose", "chooseleaf"):
                    raise ValueError(f"unknown rule step op {op!r}")
                # n == 0 means "result_max" — resolved at do_rule time.
                rule_steps.append((f"{op}_indep", int(n), type_name))
            rule_steps.append(("emit",))
            return self.add_rule(Rule(name, rule_steps))
        return self.add_rule(Rule(name, [
            take,
            ("chooseleaf_indep", chunk_count, failure_domain),
            ("emit",),
        ]))

    # -- serialization (CrushWrapper encode/decode role) ------------------
    def to_dict(self) -> dict:
        return {
            "tunables": {
                "choose_total_tries": self.tunables.choose_total_tries,
                "choose_local_retries": self.tunables.choose_local_retries,
                "choose_local_fallback_retries":
                    self.tunables.choose_local_fallback_retries,
                "chooseleaf_descend_once":
                    self.tunables.chooseleaf_descend_once,
                "chooseleaf_vary_r": self.tunables.chooseleaf_vary_r,
                "chooseleaf_stable": self.tunables.chooseleaf_stable,
            },
            "types": dict(self.types),
            "buckets": [
                {
                    "id": b.id, "type_id": b.type_id, "name": b.name,
                    "alg": b.alg, "items": list(b.items),
                    "weights": list(b.weights),
                }
                for b in self.buckets.values()
                if b.id not in self._shadow_ids   # derived, rebuildable
            ],
            "rules": [
                {
                    "name": r.name, "rule_id": r.rule_id,
                    "steps": [list(s) for s in r.steps],
                }
                for r in self.rules.values()
            ],
            "max_device": self.max_device,
            "parent": {str(c): p for c, p in self._parent.items()},
            "choose_args": {
                name: {str(b): list(w) for b, w in per_bucket.items()
                       if b not in self._shadow_ids}
                for name, per_bucket in self.choose_args.items()
            },
            "class_map": {str(d): c for d, c in self.class_map.items()},
            "class_bucket": {
                str(b): dict(per_cls)
                for b, per_cls in self.class_bucket.items()
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CrushMap":
        m = cls(Tunables(**d["tunables"]))
        m.types = {str(k): int(v) for k, v in d["types"].items()}
        for bd in d["buckets"]:
            b = Bucket(int(bd["id"]), int(bd["type_id"]), bd["name"],
                       bd["alg"], list(bd["items"]), list(bd["weights"]))
            m.buckets[b.id] = b
            m.names[b.name] = b.id
        m._next_bucket_id = min(m.buckets, default=0) - 1
        for rd in d["rules"]:
            m.rules[rd["name"]] = Rule(
                rd["name"], [tuple(s) for s in rd["steps"]],
                int(rd["rule_id"]),
            )
        m.max_device = int(d["max_device"])
        m._parent = {int(c): int(p) for c, p in d["parent"].items()}
        m.choose_args = {
            str(name): {int(b): [int(x) for x in w]
                        for b, w in per_bucket.items()}
            for name, per_bucket in d.get("choose_args", {}).items()
        }
        m.class_map = {int(dev): str(c)
                       for dev, c in d.get("class_map", {}).items()}
        m.class_bucket = {
            int(b): {str(c): int(sid) for c, sid in per_cls.items()}
            for b, per_cls in d.get("class_bucket", {}).items()
        }
        shadow_ids = [sid for per in m.class_bucket.values()
                      for sid in per.values()]
        m._next_bucket_id = min(
            [m._next_bucket_id] + [s - 1 for s in shadow_ids])
        return m

    # -- mapping ---------------------------------------------------------
    def _is_out(self, reweights, item: int, x: int) -> bool:
        """Reweight test (mapper.c:424): probabilistically reject devices
        with reweight < 1.0."""
        if reweights is None:
            return False
        if item >= len(reweights):
            return True
        w = reweights[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (int(crush_hash32_2(x, item)) & 0xFFFF) >= w

    def _bucket_weights(self, bucket: Bucket) -> list[int]:
        if self._active_weights is not None:
            override = self._active_weights.get(bucket.id)
            if override is not None and len(override) == len(bucket.items):
                return override
        return bucket.weights

    def _bucket_choose(self, bucket: Bucket, x: int, r: int) -> int:
        if bucket.alg == "uniform":
            # uniform buckets: hash-pick ignoring weights
            idx = int(crush_hash32_2(x, bucket.id + r * 2654435761)) % len(
                bucket.items
            )
            return bucket.items[idx]
        if bucket.alg == "list":
            return self._list_choose(bucket, x, r)
        if bucket.alg == "tree":
            return self._tree_choose(bucket, x, r)
        draws = straw2_draws(x, bucket.items,
                             self._bucket_weights(bucket), r)
        return bucket.items[int(np.argmax(draws))]

    def _list_choose(self, bucket: Bucket, x: int, r: int) -> int:
        """List bucket: sequential weighted draw from the most recently
        added item (crush.h CRUSH_BUCKET_LIST; O(1) when adding at the
        head, O(n) lookup).  For each item the draw succeeds with
        probability item_weight / weight_of_remaining_suffix."""
        weights = self._bucket_weights(bucket)
        n = len(bucket.items)
        prefix = [0] * n           # prefix[j] = sum(weights[:j+1])
        acc = 0
        for j in range(n):
            acc += weights[j]
            prefix[j] = acc
        # iterate newest (tail) first; item j wins with probability
        # weights[j] / weight(items[0..j]); j == 0 is the certain floor
        for j in range(n - 1, -1, -1):
            if prefix[j] <= 0:
                continue
            draw = int(crush_hash32_4(x, bucket.items[j], r, bucket.id))
            draw &= 0xFFFF
            if (draw * prefix[j]) >> 16 < weights[j]:
                return bucket.items[j]
        return bucket.items[0]

    def _tree_heap(self, bucket: Bucket,
                   weights: list[int]) -> tuple[list[int], int]:
        """Implicit-heap subtree weights for a tree bucket, cached per
        (bucket, weight vector) so a draw is O(log n), not O(n log n).
        The key is the weight *content*: bucket.weights mutates in place
        on add_item and choose_args vectors are distinct list objects, so
        identity/fingerprint keys could alias stale heaps."""
        key = (bucket.id, tuple(weights))
        cached = self._tree_heap_cache.get(key)
        if cached is not None:
            return cached
        n = len(bucket.items)
        leaf_total = 1
        while leaf_total < n:
            leaf_total *= 2
        first_leaf = leaf_total - 1
        heap = [0] * (first_leaf + leaf_total)
        for i in range(n):
            heap[first_leaf + i] = weights[i]
        for k in range(first_leaf - 1, -1, -1):
            heap[k] = heap[2 * k + 1] + heap[2 * k + 2]
        self._tree_heap_cache[key] = (heap, first_leaf)
        if len(self._tree_heap_cache) > 4096:
            self._tree_heap_cache.clear()
        return heap, first_leaf

    def _tree_choose(self, bucket: Bucket, x: int, r: int) -> int:
        """Tree bucket: weighted binary descent over an implicit heap of
        subtree weights (crush.h CRUSH_BUCKET_TREE; O(log n) draws).
        Node k's children are 2k+1 / 2k+2 in the heap; leaves map to
        items in order."""
        weights = self._bucket_weights(bucket)
        n = len(bucket.items)
        if n == 1:
            return bucket.items[0]
        heap, first_leaf = self._tree_heap(bucket, weights)
        k = 0
        while k < first_leaf:
            left, right = 2 * k + 1, 2 * k + 2
            lw = heap[left]
            total = lw + heap[right]
            if total <= 0:
                return bucket.items[0]
            draw = int(crush_hash32_4(x, bucket.id, r, k)) & 0xFFFF
            k = left if (draw * total) >> 16 < lw else right
        return bucket.items[k - first_leaf]

    def _choose_firstn(
        self, bucket: Bucket, x: int, numrep: int, type_id: int,
        out: list[int], out2: list[int] | None, reweights,
        tries: int, recurse_tries: int, recurse_to_leaf: bool,
        parent_r: int = 0, stable: bool | None = None,
    ) -> None:
        """crush_choose_firstn (mapper.c:461) semantics."""
        t = self.tunables
        stable = t.chooseleaf_stable if stable is None else stable
        outpos = len(out)
        rep_range = range(0, numrep) if stable else range(outpos, numrep)
        for rep in rep_range:
            if len(out) >= numrep:
                break
            ftotal = 0
            item = None
            while True:  # descent retries
                node = bucket
                r = rep + parent_r + ftotal
                ok = False
                while True:  # walk down through intervening buckets
                    if not node.items:
                        break
                    item = self._bucket_choose(node, x, r)
                    itemtype = (
                        DEVICE_TYPE if item >= 0
                        else self.buckets[item].type_id
                    )
                    if itemtype != type_id:
                        if item >= 0:
                            break  # bad: device where bucket expected
                        node = self.buckets[item]
                        continue
                    # candidate at the target type
                    if item in out:
                        break  # collision
                    if recurse_to_leaf and item < 0:
                        sub_r = r >> (t.chooseleaf_vary_r - 1) \
                            if t.chooseleaf_vary_r else 0
                        leaf_out: list[int] = []
                        self._choose_firstn(
                            self.buckets[item], x, 1, DEVICE_TYPE,
                            leaf_out, None, reweights,
                            recurse_tries, 0, False,
                            parent_r=sub_r, stable=True,
                        )
                        if not leaf_out or leaf_out[0] in (out2 or []):
                            break  # no leaf / leaf collision
                        if out2 is not None:
                            out2.append(leaf_out[0])
                        ok = True
                        break
                    if itemtype == DEVICE_TYPE and self._is_out(
                        reweights, item, x
                    ):
                        break  # rejected by reweight
                    if recurse_to_leaf and item >= 0 and out2 is not None:
                        out2.append(item)
                    ok = True
                    break
                if ok:
                    out.append(item)
                    break
                ftotal += 1
                if ftotal >= tries:
                    break  # skip this replica

    def _choose_indep(
        self, bucket: Bucket, x: int, numrep: int, type_id: int,
        out: list[int], out2: list[int] | None, reweights,
        tries: int, recurse_tries: int, recurse_to_leaf: bool,
        parent_r: int = 0,
    ) -> None:
        """crush_choose_indep (mapper.c:650): breadth-first, positionally
        stable, holes allowed (ITEM_NONE)."""
        endpos = numrep
        while len(out) < endpos:
            out.append(None)  # UNDEF
            if out2 is not None:
                out2.append(None)
        left = sum(1 for v in out if v is None)
        for ftotal in range(tries):
            if left <= 0:
                break
            for rep in range(endpos):
                if out[rep] is not None:
                    continue
                node = bucket
                while True:
                    # r recomputed per descent level from the CURRENT node
                    # (mapper.c:721-727): uniform buckets whose size divides
                    # numrep get the (numrep+1) anti-cycling stride.
                    r = rep + parent_r
                    if (node.alg == "uniform"
                            and len(node.items) % numrep == 0):
                        r += (numrep + 1) * ftotal
                    else:
                        r += numrep * ftotal
                    if not node.items:
                        break
                    item = self._bucket_choose(node, x, r)
                    itemtype = (
                        DEVICE_TYPE if item >= 0
                        else self.buckets[item].type_id
                    )
                    if itemtype != type_id:
                        if item >= 0:
                            out[rep] = ITEM_NONE
                            if out2 is not None:
                                out2[rep] = ITEM_NONE
                            left -= 1
                            break
                        node = self.buckets[item]
                        continue
                    if item in out:
                        break  # collision; retry next ftotal round
                    if recurse_to_leaf and item < 0:
                        self._choose_indep_leaf(
                            self.buckets[item], x, rep, numrep,
                            out2, reweights, recurse_tries, r,
                        )
                        if out2 is not None and out2[rep] is None:
                            break  # no leaf
                    if itemtype == DEVICE_TYPE and self._is_out(
                        reweights, item, x
                    ):
                        break  # rejected by reweight; retry next round
                    if recurse_to_leaf and item >= 0 and out2 is not None:
                        out2[rep] = item
                    out[rep] = item
                    left -= 1
                    break
        for rep in range(endpos):
            if out[rep] is None:
                out[rep] = ITEM_NONE
                if out2 is not None:
                    # never leak a leaf from an attempt whose position
                    # ultimately failed
                    out2[rep] = ITEM_NONE
            if out2 is not None and out2[rep] is None:
                out2[rep] = ITEM_NONE

    def _choose_indep_leaf(
        self, bucket: Bucket, x: int, rep: int, numrep: int,
        out2: list, reweights, tries: int, parent_r: int,
    ) -> None:
        """The chooseleaf recursion of indep: place 1 leaf at position rep
        (mapper.c:782-791: recursive call with left=1)."""
        node = bucket
        for ftotal in range(tries):
            node = bucket
            r = rep + parent_r + numrep * ftotal
            placed = False
            while True:
                if not node.items:
                    break
                item = self._bucket_choose(node, x, r)
                if item < 0:
                    node = self.buckets[item]
                    continue
                if item in (out2 or []):
                    break
                if self._is_out(reweights, item, x):
                    break
                out2[rep] = item
                placed = True
                break
            if placed:
                return

    def map_pgs(
        self,
        rule: Rule | str,
        xs: Sequence[int],
        result_max: int,
        reweights: Sequence[int] | None = None,
        choose_args: str | None = None,
    ) -> np.ndarray:
        """Bulk PG mapping (the OSDMapMapping.cc threaded-bulk analog,
        reference src/osd/OSDMapMapping.cc): map many placement inputs at
        once. Returns (len(xs), result_max) int32, ITEM_NONE-padded.
        See placement.bulk.map_pgs_bulk for the vectorized machine."""
        out = np.full((len(xs), result_max), ITEM_NONE, np.int32)
        for i, x in enumerate(xs):
            row = self.do_rule(rule, int(x), result_max, reweights,
                               choose_args)
            out[i, : len(row)] = row
        return out

    def do_rule(
        self,
        rule: Rule | str,
        x: int,
        result_max: int,
        reweights: Sequence[int] | None = None,
        choose_args: str | None = None,
    ) -> list[int]:
        """Evaluate a rule for input x (crush_do_rule, mapper.c:900).

        Returns up to result_max ids; indep rules pad holes with ITEM_NONE.
        ``reweights``: per-device 16.16 reweight vector for is_out.
        ``choose_args``: name of a weight-set whose per-bucket weights
        override the hierarchy weights during draws (CrushWrapper
        choose_args); unknown names fall back to the real weights.
        """
        if isinstance(rule, str):
            rule = self.rules[rule]
        self._active_weights = self.choose_args.get(choose_args or "")
        try:
            return self._do_rule_steps(rule, x, result_max, reweights)
        finally:
            self._active_weights = None

    def _do_rule_steps(self, rule: Rule, x: int, result_max: int,
                       reweights) -> list[int]:
        t = self.tunables
        tries = t.choose_total_tries + 1
        result: list[int] = []
        w: list[int] = []
        for step in rule.steps:
            op = step[0]
            if op == "take":
                name = step[1]
                if name not in self.names:
                    raise KeyError(f"take: unknown bucket {name!r}")
                cls = step[2] if len(step) > 2 else ""
                if cls:
                    shadow = self._class_shadow(
                        self.buckets[self.names[name]], cls)
                    # no device of that class under the root: empty map
                    w = [] if shadow is None else [shadow.id]
                else:
                    w = [self.names[name]]
            elif op == "emit":
                result.extend(w[: result_max - len(result)])
                w = []
            elif op in ("choose_firstn", "chooseleaf_firstn",
                        "choose_indep", "chooseleaf_indep"):
                numrep, type_name = step[1], step[2]
                if numrep <= 0:
                    numrep += result_max
                type_id = self.types[type_name]
                leaf = op.startswith("chooseleaf")
                firstn = op.endswith("firstn")
                recurse_tries = (
                    1 if t.chooseleaf_descend_once else tries
                ) if firstn else 1
                out: list[int] = []
                out2: list[int] = [] if leaf else None
                for wid in w:
                    if wid >= 0 or wid not in self.buckets:
                        continue
                    if firstn:
                        self._choose_firstn(
                            self.buckets[wid], x, numrep, type_id,
                            out, out2, reweights, tries, recurse_tries,
                            leaf,
                        )
                    else:
                        # Each work-item gets its own slab of numrep
                        # positions (mapper.c:1019 o+osize per bucket).
                        slab: list[int] = []
                        slab2: list[int] | None = [] if leaf else None
                        self._choose_indep(
                            self.buckets[wid], x, numrep, type_id,
                            slab, slab2, reweights, tries, recurse_tries,
                            leaf,
                        )
                        out.extend(slab)
                        if leaf:
                            out2.extend(slab2)
                w = out2 if leaf else out
            else:
                raise ValueError(f"unknown rule op {op!r}")
        return result

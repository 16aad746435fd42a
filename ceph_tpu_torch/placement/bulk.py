"""Bulk CRUSH mapping: the whole PG space in one vectorized evaluation.

Counterpart of ceph_tpu/placement/bulk.py: the same module over the
port's imports.

The vectorised analog of reference src/osd/OSDMapMapping.{h,cc} (threaded
bulk mapping of every PG after each map change): instead of sharding a
per-PG C loop over threads, the rule machine runs ONCE with every
placement input as a numpy vector — straw2 draws for all inputs against
a bucket are a single (X, N) expression (straw2.straw2_draws), and the
retry/collision logic becomes masked iteration.  Semantics are
BIT-IDENTICAL to CrushMap.do_rule (asserted by tests over randomized
hierarchies); rule shapes outside the supported set fall back to the
scalar machine per input.

Supported: single take + one choose_firstn/chooseleaf_firstn step +
emit, over straw2/uniform buckets, modern tunables (the replicated-pool
shape OSDMapMapping exercises).  Indep (EC) rules and multi-step rules
use the scalar fallback.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.placement.crush_map import (
    DEVICE_TYPE,
    ITEM_NONE,
    CrushMap,
    Rule,
)
from ceph_tpu_torch.placement.hashing import crush_hash32_2
from ceph_tpu_torch.placement.straw2 import straw2_draws

_DEAD = np.int64(-(2**31))      # descent dead-end marker (never an id)


def _supported(m: CrushMap, rule: Rule) -> bool:
    if len(rule.steps) != 3:
        return False
    if rule.steps[0][0] != "take" or rule.steps[2][0] != ("emit",)[0]:
        return False
    op = rule.steps[1][0]
    if op not in ("choose_firstn", "chooseleaf_firstn"):
        return False
    t = m.tunables
    if not (t.chooseleaf_descend_once and t.chooseleaf_stable
            and t.chooseleaf_vary_r == 1):
        return False
    return all(b.alg in ("straw2", "uniform")
               for b in m.buckets.values())


def _bucket_choose_vec(m: CrushMap, bucket, xs: np.ndarray,
                       r: np.ndarray) -> np.ndarray:
    """Vectorized _bucket_choose for one bucket over (xs, r) pairs."""
    if bucket.alg == "uniform":
        b = (np.int64(bucket.id)
             + r.astype(np.int64) * np.int64(2654435761)) \
            & np.int64(0xFFFFFFFF)
        h = crush_hash32_2(xs.astype(np.uint32), b.astype(np.uint32))
        idx = h.astype(np.int64) % len(bucket.items)
        return np.asarray(bucket.items, np.int64)[idx]
    weights = m._bucket_weights(bucket)
    draws = straw2_draws(xs, bucket.items, weights, r)
    return np.asarray(bucket.items, np.int64)[np.argmax(draws, axis=1)]


def _is_out_vec(reweights, items: np.ndarray,
                xs: np.ndarray) -> np.ndarray:
    """Vectorized CrushMap._is_out over (x, device) pairs."""
    if reweights is None:
        return np.zeros(len(items), bool)
    rw = np.asarray(reweights, np.int64)
    safe = np.clip(items, 0, len(rw) - 1)
    w = np.where(items < len(rw), rw[safe], 0)
    h = crush_hash32_2(xs.astype(np.uint32),
                       items.astype(np.uint32)).astype(np.int64)
    out = (h & 0xFFFF) >= w
    return np.where(w >= 0x10000, False,
                    np.where(w == 0, True, out))


def _descend_vec(m: CrushMap, start: np.ndarray, xs: np.ndarray,
                 r: np.ndarray, type_id: int,
                 active: np.ndarray) -> np.ndarray:
    """Walk each active input down from its start bucket until an item
    of type_id is drawn; _DEAD marks dead ends (empty bucket / device
    where a bucket was expected)."""
    node = start.copy()
    settled = ~active.copy()
    result = np.full(len(xs), _DEAD, np.int64)
    # hierarchy depth bounds the walk
    for _ in range(len(m.buckets) + 2):
        todo = ~settled
        if not todo.any():
            break
        for bid in np.unique(node[todo]):
            sel = todo & (node == bid)
            bucket = m.buckets.get(int(bid))
            if bucket is None or not bucket.items:
                settled |= sel          # dead end: result stays _DEAD
                continue
            chosen = _bucket_choose_vec(m, bucket, xs[sel], r[sel])
            ctype = np.where(
                chosen >= 0, DEVICE_TYPE,
                np.asarray([
                    m.buckets[int(c)].type_id if c < 0 else DEVICE_TYPE
                    for c in chosen
                ], np.int64),
            )
            at_target = ctype == type_id
            bad_device = (chosen >= 0) & ~at_target
            idx = np.flatnonzero(sel)
            result[idx[at_target]] = chosen[at_target]
            settled[idx[at_target]] = True
            settled[idx[bad_device]] = True     # stays _DEAD
            cont = ~at_target & ~bad_device
            node[idx[cont]] = chosen[cont]
    return result


def map_pgs_bulk(m: CrushMap, rule: Rule | str, xs, result_max: int,
                 reweights=None,
                 choose_args: str | None = None) -> np.ndarray:
    """Vectorized CrushMap.map_pgs; falls back to the scalar machine
    for unsupported shapes.  Returns (X, result_max) int32 padded with
    ITEM_NONE (failed replicas compact left, like do_rule's emit)."""
    if isinstance(rule, str):
        rule = m.rules[rule]
    if not _supported(m, rule):
        return m.map_pgs(rule, xs, result_max, reweights, choose_args)
    xs = np.asarray(list(xs), np.int64)
    X = len(xs)
    m._active_weights = m.choose_args.get(choose_args or "")
    try:
        op, numrep, type_name = rule.steps[1]
        if numrep <= 0:
            numrep += result_max
        # numrep stays UNCAPPED: the scalar machine computes every
        # replica slot and only emit truncates, so a skipped slot can
        # be backfilled by a later one (bit-identity requires the same)
        type_id = m.types[type_name]
        leaf = op.startswith("chooseleaf")
        step0 = rule.steps[0]
        cls = step0[2] if len(step0) > 2 else ""
        if cls:
            # class-restricted take: walk the shadow tree (an ordinary
            # bucket tree) so classed pools keep the vectorized path
            shadow = m._class_shadow(m.buckets[m.names[step0[1]]], cls)
            if shadow is None:
                return np.full((X, result_max), ITEM_NONE, np.int32)
            take_id = shadow.id
        else:
            take_id = m.names[step0[1]]
        tries = m.tunables.choose_total_tries + 1

        out = np.full((X, numrep), np.int64(ITEM_NONE), np.int64)
        out2 = np.full((X, numrep), np.int64(ITEM_NONE), np.int64) \
            if leaf else None
        start = np.full(X, np.int64(take_id))
        for rep in range(numrep):
            ftotal = np.zeros(X, np.int64)
            undone = np.ones(X, bool)
            while undone.any():
                r = rep + ftotal
                item = _descend_vec(m, start, xs, r, type_id, undone)
                ok = undone & (item != _DEAD)
                # collision with prior successes at the target type
                ok &= ~(out == item[:, None]).any(axis=1)
                if leaf:
                    # single leaf attempt (descend_once) inside the
                    # chosen failure domain; vary_r=1 -> sub_r = r
                    cand = np.flatnonzero(ok & (item < 0))
                    if len(cand):
                        leaf_item = _descend_vec(
                            m, item[cand], xs[cand], r[cand],
                            DEVICE_TYPE,
                            np.ones(len(cand), bool),
                        )
                        lok = leaf_item != _DEAD
                        lok &= ~(out2[cand] ==
                                 leaf_item[:, None]).any(axis=1)
                        lok &= ~_is_out_vec(reweights, leaf_item,
                                            xs[cand])
                        ok[cand[~lok]] = False
                        good = cand[lok]
                        out2[good, rep] = leaf_item[lok]
                    direct = ok & (item >= 0)
                    if direct.any():
                        dsel = np.flatnonzero(direct)
                        dok = ~_is_out_vec(reweights, item[dsel],
                                           xs[dsel])
                        dok &= ~(out2[dsel] ==
                                 item[dsel, None]).any(axis=1)
                        ok[dsel[~dok]] = False
                        out2[dsel[dok], rep] = item[dsel[dok]]
                elif type_id == DEVICE_TYPE:
                    dsel = np.flatnonzero(ok)
                    if len(dsel):
                        dok = ~_is_out_vec(reweights, item[dsel],
                                           xs[dsel])
                        ok[dsel[~dok]] = False
                out[np.flatnonzero(ok), rep] = item[ok]
                undone &= ~ok
                ftotal[undone] += 1
                give_up = undone & (ftotal >= tries)
                undone &= ~give_up       # replica skipped
        final = out2 if leaf else out
        # emit semantics: failures compact left, ITEM_NONE pads
        padded = np.full((X, result_max), ITEM_NONE, np.int32)
        for i in range(X):
            row = final[i][final[i] != np.int64(ITEM_NONE)]
            padded[i, :len(row)] = row[:result_max]
        return padded
    finally:
        m._active_weights = None

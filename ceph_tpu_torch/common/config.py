"""Typed config registry + live proxy.

Counterpart of ceph_tpu/common/config.py: the same module over the
port's imports.

The shape of the reference's option system (src/common/options.cc — one
typed schema with metadata; src/common/config.h:70 md_config_t;
config_proxy.h ConfigProxy; config_obs.h observers), with sources merged in
the same precedence order: schema defaults < config file < central config db
(mon) < environment < runtime overrides. ~Levels and runtime-changeable
flags are preserved; the 2,000-option catalogue grows as subsystems land.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Mapping

class Level(Enum):
    BASIC = "basic"
    ADVANCED = "advanced"
    DEV = "dev"


@dataclass
class Option:
    name: str
    type: type = str  # str | int | float | bool
    default: Any = None
    description: str = ""
    level: Level = Level.ADVANCED
    min: float | None = None
    max: float | None = None
    enum_values: tuple = ()
    runtime: bool = True  # changeable without restart

    def validate(self, value):
        try:
            if self.type is bool and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            else:
                value = self.type(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"option {self.name}: {value!r} is not {self.type.__name__}"
            ) from None
        if self.min is not None and value < self.min:
            raise ValueError(f"option {self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"option {self.name}: {value} > max {self.max}")
        if self.enum_values and value not in self.enum_values:
            raise ValueError(
                f"option {self.name}: {value!r} not in {self.enum_values}"
            )
        return value


def global_options() -> list[Option]:
    """The built-in schema (get_global_options analog). Subsystems extend
    via ConfigProxy.register()."""
    return [
        Option("cluster", str, "ceph-tpu", "cluster name", Level.BASIC),
        Option("osd_pool_default_size", int, 3, "replica count", min=1),
        Option("osd_pool_default_min_size", int, 0, "min replicas to serve"),
        Option("osd_pool_default_pg_num", int, 32, "default pg count", min=1),
        Option("osd_heartbeat_interval", float, 0.5, "peer ping interval (s)",
               min=0.01),
        Option("osd_heartbeat_grace", float, 3.0,
               "seconds of silence before reporting a peer down", min=0.1),
        Option("mon_osd_min_down_reporters", int, 1,
               "distinct reporters required to mark an osd down", min=1),
        Option("mon_osd_down_out_interval", float, 30.0,
               "seconds before a down osd is marked out"),
        Option("mon_osdmap_keep_epochs", int, 200,
               "OSDMap full+incremental epochs the mon store retains; "
               "subscribers older than the trim horizon get a full map "
               "(mon_min_osdmap_epochs trim role)", min=1),
        Option("osd_heartbeat_peer_limit", int, 0,
               "max peers each OSD pings (ring successors by id); 0 = "
               "all up OSDs.  The all-to-all default builds an O(n^2) "
               "connection mesh that melts one-process clusters past "
               "~100 OSDs (maybe_update_heartbeat_peers role)", min=0),
        Option("paxos_propose_interval", float, 0.0,
               "delay before committing staged boot/failure map changes "
               "so a burst coalesces into one epoch (0 = immediate)",
               min=0.0),
        Option("osd_erasure_code_plugins", str, "jax_rs lrc shec clay xor",
               "plugins preloaded at osd start"),
        Option("osd_recovery_max_active", int, 8,
               "max concurrent recovery ops", min=1),
        Option("osd_pg_log_max_entries", int, 250,
               "retained pg log entries per PG (trim boundary)", min=8),
        Option("osd_map_history_keep", int, 64,
               "full OSDMap epochs each OSD persists in its meta "
               "collection (the mon-store rebuild harvest source; "
               "0 = off)", min=0),
        Option("osd_op_queue", str, "mclock_scheduler",
               "op scheduler: mclock_scheduler or fifo",
               enum_values=("mclock_scheduler", "fifo")),
        # dmClock per-class QoS knobs (osd_mclock_scheduler_* analogs);
        # limit 0 = uncapped
        Option("osd_mclock_client_res", float, 100.0,
               "client reservation (ops/s)"),
        Option("osd_mclock_client_wgt", float, 10.0, "client weight"),
        Option("osd_mclock_client_lim", float, 0.0, "client limit"),
        Option("osd_mclock_recovery_res", float, 10.0,
               "recovery reservation (ops/s)"),
        Option("osd_mclock_recovery_wgt", float, 1.0, "recovery weight"),
        Option("osd_mclock_recovery_lim", float, 0.0, "recovery limit"),
        Option("osd_scrub_interval", float, 0.0,
               "seconds between automatic PG scrubs (0 = manual only)"),
        Option("osd_scrub_jitter", float, 0.5,
               "randomize each background scrub tick up to this "
               "fraction beyond osd_scrub_interval (per-OSD seeded "
               "rng) so a fleet started together does not deep-scrub "
               "in lockstep"),
        Option("osd_mclock_scrub_res", float, 5.0,
               "scrub reservation (ops/s)"),
        Option("osd_mclock_scrub_wgt", float, 1.0, "scrub weight"),
        Option("osd_mclock_scrub_lim", float, 0.0, "scrub limit"),
        # backfill = PLANNED data motion (topology change), a distinct
        # mClock class from recovery (failure repair) so the QoS plane
        # can pace rebalance and rebuild independently
        Option("osd_mclock_backfill_res", float, 5.0,
               "backfill reservation (ops/s)"),
        Option("osd_mclock_backfill_wgt", float, 1.0,
               "backfill weight"),
        Option("osd_mclock_backfill_lim", float, 0.0, "backfill limit"),
        Option("osd_max_backfills", int, 1,
               "backfill reservation slots per OSD (local + remote): a "
               "PG's planned motion starts only once every participant "
               "granted a slot, so one daemon serves at most this many "
               "concurrent backfills", min=1),
        Option("osd_client_op_priority", int, 63, "client op priority"),
        Option("mon_lease", float, 2.0,
               "peon lease / liveness window (s)", min=0.1),
        Option("mon_lease_interval", float, 0.5,
               "leader lease-renewal period (s)", min=0.05),
        Option("mon_election_timeout", float, 1.0,
               "election round timeout (s)", min=0.05),
        Option("mon_tick_interval", float, 0.5,
               "monitor periodic tick (s)", min=0.05),
        Option("mon_accept_timeout", float, 2.0,
               "paxos accept-phase timeout (s)", min=0.1),
        Option("mon_sync_timeout", float, 5.0,
               "store-sync per-chunk timeout before retrying with "
               "another provider (s)", min=0.1),
        Option("auth_shared_key", str, "",
               "cluster shared auth key ('' = auth disabled)"),
        Option("auth_cluster_required", str, "none",
               "authentication mode: cephx (per-entity keys + tickets) "
               "or none", enum_values=("none", "cephx")),
        Option("auth_admin_key", str, "",
               "bootstrap key for client.admin ('' = generate)"),
        Option("auth_key", str, "",
               "this entity's own secret key (cephx mode)"),
        Option("auth_service_secret_ttl", float, 3600.0,
               "rotating service-secret / ticket lifetime (s)", min=0.5),
        Option("osd_agent_interval", float, 1.0,
               "cache-tier flush/evict agent period (s; 0=off)", min=0.0),
        Option("store_compression_algorithm", str, "",
               "inline at-rest compression of the object store's WAL "
               "records and checkpoint segments ('' = off; zlib, zstd, "
               "lzma, bz2 — the BlueStore compress-on-write role)",
               enum_values=("", "zlib", "zstd", "lzma", "bz2")),
        Option("osd_ec_mesh_cs", int, 0,
               "chunk-sharding axis size of the distributed EC data "
               "plane mesh (0 = single-device EC; >0 = shard encode/"
               "decode batches over all local devices with a "
               "('dp','cs') mesh, cs dividing the device count)",
               min=0),
        Option("mds_beacon_interval", float, 0.5,
               "mds -> mon beacon period (s)", min=0.05),
        Option("mds_beacon_grace", float, 3.0,
               "beacon silence before an mds is failed (s)", min=0.1),
        Option("mds_decay_halflife", float, 5.0,
               "halflife of mds dirfrag popularity counters (s)",
               min=0.1),
        Option("mds_bal_interval", float, 0.0,
               "mds balancer tick period (s; 0=off)", min=0.0),
        Option("mds_bal_min_rebalance", float, 0.25,
               "export only when this rank's load exceeds the mean "
               "by this fraction of the mean", min=0.0),
        Option("mds_bal_min_start", float, 8.0,
               "minimum load excess (decayed request counts) worth "
               "exporting a subtree for", min=0.0),
        Option("mds_bal_split_size", int, 10000,
               "dirfrag entry count that triggers a split "
               "(reference mds_bal_split_size)", min=4),
        Option("mds_bal_merge_size", int, 50,
               "combined sibling entry count below which sibling "
               "dirfrags merge back (reference mds_bal_merge_size)",
               min=0),
        Option("mds_bal_split_bits", int, 1,
               "hash bits added per dirfrag split (2^bits children; "
               "reference mds_bal_split_bits)", min=1, max=4),
        Option("trace_probability", float, 0.0,
               "fraction of client ops that carry a trace context "
               "(zipkin_trace analog; 0=off)", min=0.0, max=1.0),
        Option("osd_op_complaint_time", float, 1.0,
               "an op in flight (or finished) past this many seconds "
               "counts as slow: beaconed to the mon for the SLOW_OPS "
               "health check and retained in the forensic ring",
               min=0.01, runtime=True),
        Option("osd_slow_op_history", int, 20,
               "how many of the slowest ops keep their full event "
               "timeline + span tree (dump_historic_slow_ops)",
               Level.ADVANCED, min=1),
        Option("event_journal_size", int, 2048,
               "bound of each daemon's flight-recorder event ring "
               "(common/events.py EventJournal)", Level.ADVANCED,
               min=16),
        Option("forensics_window_s", float, 60.0,
               "trailing seconds of each event journal snapshotted "
               "into a forensic bundle on capture", min=1.0,
               runtime=True),
        Option("forensics_dir", str, "",
               "directory where the mgr persists forensic bundles "
               "('' = <tempdir>/ceph_tpu_forensics)", runtime=True),
        Option("forensics_cooldown_s", float, 30.0,
               "min seconds between automatic forensic captures (a "
               "flapping health check must not storm bundles)",
               Level.ADVANCED, min=0.0, runtime=True),
        Option("ms_secure_mode", bool, False,
               "AES-256-GCM on-wire frame encryption (crypto_onwire "
               "analog); needs a configured auth key on every daemon"),
        Option("ms_dispatch_throttle_bytes", int, 100 << 20,
               "max bytes of in-dispatch messages per peer type before "
               "the reader backpressures (0=unlimited)", min=0),
        Option("osd_client_message_size_cap", int, 500 << 20,
               "max bytes of client op payloads in flight per OSD; "
               "held for each op's LIFETIME (0=unlimited)", min=0),
        Option("admin_socket_dir", str, "",
               "directory for <entity>.asok admin sockets ('' = off)"),
        Option("ms_inject_socket_failures", int, 0,
               "1-in-N artificial connection failures (0=off); alias of "
               "failpoint msgr.send", Level.DEV),
        Option("ms_inject_delay_max", float, 0.0,
               "max artificial delivery delay (s); alias of failpoint "
               "msgr.deliver", Level.DEV),
        Option("failpoint", str, "",
               "failpoint spec applied at daemon start: "
               "name=mode[:arg][:arg],... (see common/failpoint.py)",
               Level.DEV, runtime=True),
        Option("failpoint_seed", int, 0,
               "deterministic seed for failpoint prob/chaos draws "
               "(0 = leave registry seed alone)", Level.DEV),
        Option("client_backoff_base", float, 0.05,
               "initial client resend/hunt backoff (s)", min=0.0),
        Option("client_backoff_max", float, 1.0,
               "cap on client resend/hunt backoff (s)", min=0.0),
        Option("client_op_deadline", float, 30.0,
               "default per-op deadline for Objecter ops (s)", min=0.1),
        Option("osd_ec_hedge_read_timeout", float, 0.0,
               "hedge an EC shard read after this many seconds: fan out "
               "to surviving shards and reconstruct via minimum_to_decode "
               "(0 = off)", Level.ADVANCED, min=0.0),
        Option("ec_stripe_batch", int, 1024,
               "stripes per device encode launch", min=1),
        Option("ec_use_pallas", bool, True,
               "use the fused device kernels (the port launches its "
               "hand-written CUDA kernels; the name is the JAX "
               "package's)"),
        Option("osd_ec_coalesce", bool, True,
               "coalesce concurrent in-flight EC ops' encode/decode "
               "batches into shared device launches (cross-op "
               "micro-batching; amortizes per-launch dispatch cost "
               "for small-write workloads)"),
        Option("osd_ec_coalesce_window_us", float, 200.0,
               "adaptive micro-window an EC op may wait for batchmates "
               "before its coalesced launch flushes (microseconds; "
               "flushes immediately when no other op is in flight)",
               Level.ADVANCED, min=0.0),
        Option("osd_ec_coalesce_max_stripes", int, 4096,
               "pending stripe count that forces an immediate coalesced "
               "flush regardless of the window", Level.ADVANCED, min=1),
        Option("osd_ec_mesh_coalesce", bool, False,
               "promote EC op coalescing to one host-level launcher "
               "shared by every co-located OSD: each micro-window "
               "flushes as a single shard_map launch whose stripe "
               "batch splits across ALL local devices (falls back "
               "to the per-OSD launcher on 1-device hosts and for "
               "codecs without a generator matrix); also enables "
               "cross-chip CLAY/LRC sub-chunk degraded reads"),
        Option("ec_pallas_encode_variant", str, "auto",
               "encode kernel formulation ('' = production kernel; "
               "'auto' = the production kernel on the card, where it "
               "measured fastest; variants are bit-identical, each a "
               "kernel of ec/cuda_kernels.py; the name is the JAX "
               "package's)", Level.ADVANCED,
               enum_values=("", "auto", "enc_cmp_expand",
                            "enc_u8_expand", "enc_split2",
                            "enc_u8_split2")),
        Option("osd_ec_resident", bool, True,
               "keep EC shard streams device-resident in a shared "
               "DeviceShardCache so repeated ops feed the kernel "
               "without host round-trips (host copies only at the "
               "client boundary and on store persistence)"),
        Option("osd_ec_resident_max_bytes", int, 256 << 20,
               "byte budget of the per-daemon device shard cache; "
               "crossing it evicts LRU entries to the low watermark",
               Level.ADVANCED, min=1 << 20),
        Option("osd_ec_resident_writeback", bool, False,
               "defer shard-data persistence to cache evict/flush "
               "(attrs-only store commit per write); honored only in "
               "lenient (unlogged) mode — logged acks require the "
               "store commit", Level.ADVANCED),
        Option("osd_ec_repair_batch", bool, True,
               "drain PG missing sets through the batched repair "
               "engine: degraded objects grouped by lost-shard "
               "pattern rebuild in shared decode launches with "
               "locality-aware survivor reads (LRC group-local, CLAY "
               "helper sub-chunks); objects the engine cannot serve "
               "fall back to per-object recovery"),
        Option("osd_ec_repair_batch_objects", int, 64,
               "max degraded objects per batched repair launch (one "
               "mClock recovery grant at this cost paces each batch)",
               Level.ADVANCED, min=1),
        Option("slo_put_p99_ms", float, 0.0,
               "SLO: client write p99 latency target in ms, evaluated "
               "from the windowed op_w_latency_us histograms (0 = "
               "objective disabled)", min=0.0),
        Option("slo_get_p999_ms", float, 0.0,
               "SLO: client read p999 latency target in ms "
               "(op_r_latency_us; 0 = disabled)", min=0.0),
        Option("slo_error_rate", float, 0.0,
               "SLO: max fraction of client ops failing with an IO/"
               "protocol error over the window (0 = disabled)",
               min=0.0, max=1.0),
        Option("slo_rebuild_floor_gibs", float, 0.0,
               "SLO: minimum sustained rebuild rate in GiB/s while "
               "recovery is active — a floor, not a ceiling: rebuilding "
               "slower stretches the degraded window (0 = disabled)",
               min=0.0),
        Option("slo_targets", str, "",
               "extra free-form SLO objectives, comma/space separated "
               "name=value pairs (e.g. 'op_p50_ms=5 get_p99_ms=20') "
               "for quantiles outside the typed options"),
        Option("slo_window", float, 30.0,
               "SLO evaluation sliding window in seconds (the error "
               "budget horizon each burn rate is measured over)",
               min=0.1),
        Option("slo_raise_evals", int, 2,
               "consecutive violating evaluations before SLO_VIOLATION "
               "raises (hysteresis: one noisy window must not flap "
               "health)", Level.ADVANCED, min=1),
        Option("slo_clear_evals", int, 2,
               "consecutive clean evaluations before an active "
               "SLO_VIOLATION clears", Level.ADVANCED, min=1),
        Option("slo_class_labels", str, "gold,bronze",
               "tenant/QoS class labels ops may be stamped with "
               "(loadgen --class, RGW access-key mapping); per-class "
               "op_class_<label>_latency_us histograms and burn pairs "
               "are evaluated for exactly these"),
        Option("slo_class_map", str, "",
               "RGW access-key -> tenant class assignments, comma/"
               "space separated key=class pairs (e.g. "
               "'benchkey=gold'); unmapped keys take the LAST label "
               "of slo_class_labels (bronze)", runtime=True),
        Option("slo_burn_fast_s", float, 300.0,
               "fast window of the per-class multiwindow burn pair "
               "(SRE 5m/1h model); scale down in tests/drills so the "
               "pair resolves within a run", min=0.1, runtime=True),
        Option("slo_burn_slow_s", float, 3600.0,
               "slow window of the per-class multiwindow burn pair; "
               "a class violates only while BOTH windows burn > 1.0 "
               "(fast = still happening, slow = material budget "
               "spend)", min=0.1, runtime=True),
        # mgr time-series store (common/tsdb.py): bounded per-series
        # ring buffers fed each digest cycle, three downsample tiers
        Option("tsdb_raw_points", int, 720,
               "raw-tier ring capacity per series (one point per "
               "report cycle; 720 x 5s = 1h)", min=2),
        Option("tsdb_minute_points", int, 1440,
               "minute-tier ring capacity per series (sum/count/min/"
               "max buckets; 1440 x 1m = 24h)", Level.ADVANCED, min=2),
        Option("tsdb_hour_points", int, 336,
               "hour-tier ring capacity per series (336 x 1h = 14d)",
               Level.ADVANCED, min=2),
        Option("tsdb_tier1_s", float, 60.0,
               "minute-tier bucket width in seconds", Level.ADVANCED,
               min=0.1),
        Option("tsdb_tier2_s", float, 3600.0,
               "hour-tier bucket width in seconds", Level.ADVANCED,
               min=0.1),
        Option("tsdb_max_series", int, 4096,
               "catalog bound: series beyond this are dropped and "
               "counted, never grown", Level.ADVANCED, min=1),
        Option("tsdb_digest_points", int, 60,
               "raw-tier tail points per series shipped in the 'tsdb' "
               "digest section (what 'ceph-tpu top' reads through the "
               "mon; bounds digest growth)", Level.ADVANCED, min=1),
        Option("mgr_perf_collect_delta", bool, True,
               "delta-encode mgr perf collection: OSDs ship only "
               "counters changed since the last acked collect "
               "(epoch-stamped, full resync on ack mismatch) — makes "
               "the 1000-OSD collect payload sublinear; digest/tsdb "
               "contents are bit-identical either way"),
        # adaptive QoS defense plane (mgr_qos): closes the SLO loop by
        # actuating mClock recovery shares, hedge timeouts, and RGW
        # admission from the live burn-rate signal
        Option("qos_enable", bool, False,
               "enable the closed-loop QoS controller (mgr_qos): AIMD "
               "recovery-class mClock retuning + quantile-adaptive EC "
               "hedge timeouts driven by the SLO burn signal"),
        Option("qos_backoff", float, 0.5,
               "multiplicative factor applied to the recovery-class "
               "mClock limit on each burning evaluation (after the "
               "raise hysteresis is satisfied)", Level.ADVANCED,
               min=0.05, max=0.95),
        Option("qos_ramp_ops", float, 16.0,
               "additive ops/s restored to the recovery-class limit on "
               "each clean evaluation (after the clear hysteresis)",
               Level.ADVANCED, min=0.1),
        Option("qos_recovery_max_ops", float, 256.0,
               "recovery-class mClock limit ceiling the controller "
               "ramps back to when client SLOs are healthy",
               Level.ADVANCED, min=1.0),
        Option("qos_recovery_min_ops", float, 4.0,
               "absolute floor for the recovery-class mClock limit: "
               "backoff never starves rebuild below this pace",
               Level.ADVANCED, min=0.1),
        Option("qos_recovery_min_share", float, 0.05,
               "recovery pacing floor as a fraction of "
               "qos_recovery_max_ops (combined with the ops floor and "
               "the slo_rebuild_floor_gibs-derived floor via max)",
               Level.ADVANCED, min=0.0, max=1.0),
        Option("qos_recovery_gib_per_op", float, 1e-3,
               "assumed GiB rebuilt per recovery-class mClock grant, "
               "used to translate slo_rebuild_floor_gibs into a "
               "minimum recovery ops/s", Level.ADVANCED, min=1e-9),
        Option("qos_backfill_max_ops", float, 128.0,
               "backfill-class mClock limit ceiling the controller "
               "ramps back to when client SLOs are healthy (planned "
               "motion gets its own AIMD position, separate from "
               "recovery)", Level.ADVANCED, min=1.0),
        Option("qos_backfill_min_ops", float, 2.0,
               "absolute floor for the backfill-class mClock limit: "
               "backoff never parks planned motion below this pace",
               Level.ADVANCED, min=0.1),
        Option("qos_backfill_min_share", float, 0.02,
               "backfill pacing floor as a fraction of "
               "qos_backfill_max_ops (combined with the ops floor via "
               "max; no rebuild-GiB term — redundancy is intact during "
               "planned motion, so backfill may be squeezed harder "
               "than recovery)", Level.ADVANCED, min=0.0, max=1.0),
        Option("qos_scrub_max_ops", float, 64.0,
               "scrub-class mClock limit ceiling the controller ramps "
               "back to when client SLOs are healthy (integrity "
               "verification gets the third AIMD position)",
               Level.ADVANCED, min=1.0),
        Option("qos_scrub_min_ops", float, 1.0,
               "absolute floor for the scrub-class mClock limit: "
               "backoff never parks verification below this pace",
               Level.ADVANCED, min=0.1),
        Option("qos_scrub_min_share", float, 0.01,
               "scrub pacing floor as a fraction of qos_scrub_max_ops "
               "(combined with the ops floor via max; scrub verifies "
               "fully-redundant data, so of the three background "
               "classes it is squeezed hardest when clients burn)",
               Level.ADVANCED, min=0.0, max=1.0),
        Option("qos_replication_max_ops", float, 64.0,
               "multisite replication-class pacing ceiling in sync "
               "ops/s the controller ramps back to when client SLOs "
               "are healthy (the fourth AIMD position; 0 pushed to an "
               "agent means unlimited, the controller never pushes 0)",
               Level.ADVANCED, min=1.0),
        Option("qos_replication_min_ops", float, 2.0,
               "absolute floor for the replication-class pacing rate: "
               "backoff never parks geo-replication below this pace — "
               "this floor is the knob bounding how fast RPO may grow "
               "while clients burn", Level.ADVANCED, min=0.1),
        Option("qos_replication_min_share", float, 0.05,
               "replication pacing floor as a fraction of "
               "qos_replication_max_ops (combined with the ops floor "
               "via max; unlike scrub, replication protects "
               "not-yet-redundant bytes, so its floor sits above the "
               "scrub share)", Level.ADVANCED, min=0.0, max=1.0),
        Option("qos_hedge_quantile", float, 0.95,
               "derive each OSD's EC hedge-read timeout from this "
               "quantile of its windowed shard-read latency histogram "
               "(0 = adaptive hedging off; the static "
               "osd_ec_hedge_read_timeout then applies unchanged)",
               min=0.0, max=0.9999),
        Option("qos_hedge_min_ms", float, 5.0,
               "clamp floor for the adaptive hedge timeout in ms "
               "(hedging below the healthy tail wastes reads)",
               Level.ADVANCED, min=0.1),
        Option("qos_hedge_max_ms", float, 250.0,
               "clamp ceiling for the adaptive hedge timeout in ms",
               Level.ADVANCED, min=1.0),
        Option("qos_hedge_min_samples", int, 16,
               "minimum shard reads in the window before the adaptive "
               "hedge timeout retunes (thin histograms stay on the "
               "last pushed value)", Level.ADVANCED, min=1),
        Option("rgw_max_inflight", int, 0,
               "RGW admission control: max S3 requests in flight per "
               "frontend before new ones shed with 503 Slow Down "
               "(0 = gate disabled)", min=0),
        Option("rgw_session_ops_per_s", float, 0.0,
               "RGW admission control: per-session (access key) "
               "token-bucket refill rate in requests/s (0 = throttle "
               "disabled)", min=0.0),
        Option("rgw_session_burst", float, 8.0,
               "RGW admission control: per-session token-bucket "
               "capacity (burst size)", Level.ADVANCED, min=1.0),
        Option("rgw_retry_after_s", float, 1.0,
               "Retry-After header value (seconds) on 503 Slow Down "
               "responses", Level.ADVANCED, min=0.0),
        Option("rgw_datalog_shards", int, 1,
               "number of bucket-datalog shards per bucket: mutations "
               "hash by object key onto a shard log, multisite sync "
               "agents keep one replication cursor per shard so replay "
               "and trim parallelise (1 = single legacy log object)",
               min=1, max=4096),
        Option("rgw_gc_obj_min_wait", float, 0.0,
               "defer RGW data-object deletion this many seconds "
               "(rgw_gc_obj_min_wait): >0 routes overwrites through "
               "unique per-write data oids + the GC queue, so a GET "
               "racing an overwrite of the same key never hits a "
               "removed-object window (0 = delete inline)",
               Level.ADVANCED, min=0.0),
        Option("ec_hbm_peak_gibps", float, 3120.0,
               "accelerator HBM peak bandwidth in GiB/s (an H100 SXM's "
               "data-sheet 3.35 TB/s = 3120 GiB/s) — the roofline the "
               "utilization telemetry reports achieved device GiB/s "
               "against", Level.ADVANCED,
               min=1.0),
        Option("log_to_memory_ring", bool, True, "keep crash ring buffer"),
        Option("debug_default", int, 1, "default subsystem debug level",
               min=0, max=20),
    ]


class ConfigProxy:
    """Thread-safe merged view of the config sources + observer fan-out."""

    def __init__(self, conf_file: str | None = None,
                 overrides: Mapping[str, Any] | None = None):
        self._lock = threading.RLock()
        self._schema: dict[str, Option] = {}
        self._values: dict[str, Any] = {}        # merged non-default values
        self._sources: dict[str, str] = {}       # name -> source tag
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        for opt in global_options():
            self._schema[opt.name] = opt
        if conf_file and os.path.exists(conf_file):
            with open(conf_file) as f:
                for name, value in json.load(f).items():
                    self._apply(name, value, "file")
        for name, opt in self._schema.items():
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._apply(name, env, "env")
        for name, value in (overrides or {}).items():
            self._apply(name, value, "override")

    # -- schema ----------------------------------------------------------
    def register(self, options: list[Option]) -> None:
        with self._lock:
            for opt in options:
                if opt.name not in self._schema:
                    self._schema[opt.name] = opt

    def schema(self) -> dict[str, Option]:
        with self._lock:
            return dict(self._schema)

    # -- access ----------------------------------------------------------
    def _apply(self, name: str, value, source: str):
        opt = self._schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        self._values[name] = opt.validate(value)
        self._sources[name] = source

    def get(self, name: str):
        with self._lock:
            if name in self._values:
                return self._values[name]
            return self._schema[name].default

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value, source: str = "runtime") -> None:
        """Runtime set (``ceph config set`` analog); notifies observers."""
        with self._lock:
            opt = self._schema.get(name)
            if opt is None:
                raise KeyError(f"unknown option {name!r}")
            if not opt.runtime and source == "runtime":
                raise PermissionError(f"option {name} requires restart")
            self._apply(name, value, source)
            observers = list(self._observers.get(name, ()))
            value = self._values[name]
        for cb in observers:
            cb(name, value)

    def apply_central(self, values: Mapping[str, Any]) -> None:
        """Apply a central-config-db snapshot (MConfig delivery analog,
        reference mon/MonClient.cc:432). Respects precedence: values set
        from env or explicit overrides outrank the central db."""
        for name, value in values.items():
            if name in self._schema:
                if self._sources.get(name) in ("env", "override"):
                    continue
                self.set(name, value, source="mon")

    def observe(self, name: str, callback: Callable[[str, Any], None]):
        """Hot-reload observer (config_obs.h analog)."""
        with self._lock:
            self._observers.setdefault(name, []).append(callback)

    def show(self) -> dict[str, dict]:
        """``config show`` analog: every option with value + source."""
        with self._lock:
            return {
                name: {
                    "value": self.get(name),
                    "source": self._sources.get(name, "default"),
                    "level": opt.level.value,
                }
                for name, opt in sorted(self._schema.items())
            }

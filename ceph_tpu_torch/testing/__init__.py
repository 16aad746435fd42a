"""Measurement and QA tools of the port: the H100 perf lab (``perf_lab``),
the model-based op tester and the OSD thrasher that drive a ``DevCluster``
(``RadosModel``, ``Thrasher``), the seeded chaos harness and its drills
(``chaos``) and the serving load generator (``loadgen``).

Counterpart of ceph_tpu/testing/__init__.py, with the same exports.  The
zone-loss drills and the load generator's S3 backend reach the gateway,
which the port has not yet (ROADMAP A12.2): they raise until it lands.
"""

from ceph_tpu_torch.testing.chaos import (
    ChaosHarness,
    run_chaos,
    run_drain_drill,
    run_expansion_drill,
    run_host_failure_drill,
    run_rolling_restart_drill,
    run_silent_corruption_drill,
    run_zone_loss_dr_drill,
    run_zone_loss_drill,
)
from ceph_tpu_torch.testing.rados_model import RadosModel
from ceph_tpu_torch.testing.thrasher import Thrasher

__all__ = ["ChaosHarness", "RadosModel", "Thrasher", "run_chaos",
           "run_drain_drill", "run_expansion_drill",
           "run_host_failure_drill", "run_rolling_restart_drill",
           "run_silent_corruption_drill", "run_zone_loss_dr_drill",
           "run_zone_loss_drill"]

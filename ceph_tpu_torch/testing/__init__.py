"""Measurement and QA tools of the port: the H100 perf lab (``perf_lab``),
and the model-based op tester and the OSD thrasher that drive a
``DevCluster`` (``RadosModel``, ``Thrasher``)."""

from ceph_tpu_torch.testing.rados_model import RadosModel
from ceph_tpu_torch.testing.thrasher import Thrasher

__all__ = ["RadosModel", "Thrasher"]

"""Monitor: the control plane.

Counterpart of ceph_tpu/mon/__init__.py: the same module over the
port's imports.

Paxos-replicated cluster maps with the reference's shape (src/mon):
``MonitorDBStore`` (MonitorDBStore.h:37) under a single-decree-per-version
``Paxos`` (Paxos.h:174) driven by an ``Elector``; ``PaxosService``
subclasses own the maps (OSDMonitor, ConfigMonitor); ``MonClient`` is every
daemon's session — auth, subscriptions, config fetch, commands
(MonClient.h). The data path never touches monitors: clients compute
placement themselves (the "no metadata server in the data path" invariant).
"""

from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.mon.store import MonitorDBStore

__all__ = ["MonClient", "Monitor", "MonitorDBStore"]

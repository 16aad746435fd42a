"""PaxosService: base for monitor services owning a replicated map.

Counterpart of ceph_tpu/mon/service.py: the same module over the
port's imports.

Reference src/mon/PaxosService.{h,cc}: each service keeps an in-memory view
rebuilt from the store (``refresh``), answers read-only queries locally
(``preprocess_command``), and stages mutations in a pending state that the
leader encodes into one store transaction and runs through paxos
(``prepare_command`` + ``propose_pending``).
"""

from __future__ import annotations

from ceph_tpu_torch.mon.store import StoreTransaction

OK = 0
EBUSY_RC = -16
EEXIST_RC = -17
EINVAL_RC = -22
ENOENT_RC = -2
EPERM_RC = -1


class CommandResult:
    def __init__(self, rc: int = OK, outs: str = "", data=None):
        self.rc = rc
        self.outs = outs
        self.data = data

    def to_wire(self) -> dict:
        return {"rc": self.rc, "outs": self.outs, "data": self.data}


class PaxosService:
    prefix = ""                    # store prefix for this service's versions

    def __init__(self, mon):
        self.mon = mon
        self.store = mon.store

    # -- state machine hooks ---------------------------------------------
    def refresh(self) -> None:
        """Reload in-memory state from the store (post-commit/election)."""

    def create_initial(self, tx: StoreTransaction) -> None:
        """Stage genesis state (first leader of a fresh cluster)."""

    async def tick(self) -> None:
        """Periodic leader-side maintenance."""

    def health_checks(self) -> dict[str, dict]:
        """Named health checks this service contributes
        (health_check_map_t): code -> {severity, message, [detail]}."""
        return {}

    # -- commands ---------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        """Read-only fast path; None means 'needs the leader + a commit'."""
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        """Stage a mutation into ``tx`` (leader only). The result is sent
        after the paxos commit."""
        return CommandResult(EINVAL_RC, "unrecognized command")

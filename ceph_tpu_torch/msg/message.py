"""Message: the unit of control-plane exchange.

Counterpart of ceph_tpu/msg/message.py: the same module over the
port's imports.

The reference defines 163 C++ message classes (src/messages/) over a common
Message base (src/msg/Message.h). Here one generic envelope — a string type
tag plus a codec-encodable payload — replaces the class-per-type taxonomy;
subsystems define their type tags next to their handlers (mon, osd, client).
Priority mirrors CEPH_MSG_PRIO_*; seq/ack live in the frame header, not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PRIO_LOW = 64
PRIO_DEFAULT = 127
PRIO_HIGH = 196
PRIO_HIGHEST = 255


@dataclass
class Message:
    type: str
    data: dict = field(default_factory=dict)
    priority: int = PRIO_DEFAULT

    # filled in on receive
    seq: int = 0

    def to_wire(self) -> dict:
        return {"t": self.type, "d": self.data, "p": self.priority}

    @classmethod
    def from_wire(cls, wire: dict, seq: int) -> "Message":
        return cls(wire["t"], wire["d"], wire.get("p", PRIO_DEFAULT), seq)

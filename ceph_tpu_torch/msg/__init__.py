"""Messenger of the port (counterpart of ceph_tpu.msg): the host control
plane.

The wire codec (``codec``), the message envelope (``message``) and the
asyncio Messenger with ProtocolV2-style framing (``messenger``): the same
Messenger/Connection/Dispatcher surface, lossy/lossless reconnect+replay
semantics and wire bytes as the JAX package's (reference
src/msg/Messenger.h, Dispatcher.h, Policy.h), so the two packages'
messengers talk to each other.  Shard data stays on the card.
"""

from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import (
    Connection,
    Dispatcher,
    EntityAddr,
    Messenger,
    Policy,
    reset_local_namespace,
)

__all__ = [
    "Connection", "Dispatcher", "EntityAddr", "Message", "Messenger",
    "Policy", "decode", "encode", "reset_local_namespace",
]

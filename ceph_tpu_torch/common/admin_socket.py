"""AdminSocket: per-daemon unix-socket introspection.

Counterpart of ceph_tpu/common/admin_socket.py: the same module over the
port's imports.

Reference src/common/admin_socket.{h,cc} (admin_socket.h:105): every
daemon binds ``<run_dir>/<entity>.asok``; ``ceph daemon <entity> <cmd>``
connects, sends one command, reads one JSON reply.  Commands are
registered by subsystems (perf dump, dump_ops_in_flight, config show,
...); ``help`` lists them.  Protocol here: one JSON object per line in
({"prefix": ..., **args}), one JSON document out, then EOF.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import os
from typing import Callable

from ceph_tpu_torch.common.log import Dout

log = Dout("asok")


class AdminSocket:
    def __init__(self, entity: str):
        self.entity = entity
        self._commands: dict[str, tuple[Callable, str]] = {}
        self._server: asyncio.AbstractServer | None = None
        self.path: str | None = None
        self.register("help", self._help, "list registered commands")

    def register(self, prefix: str, handler: Callable,
                 help_text: str = "") -> None:
        """``handler(**args) -> jsonable``; sync or async."""
        self._commands[prefix] = (handler, help_text)

    def _help(self) -> dict:
        return {p: h for p, (_, h) in sorted(self._commands.items())}

    async def start(self, run_dir: str) -> str:
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"{self.entity}.asok")
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(
            self._serve_client, path=self.path
        )
        return self.path

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self.path:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    async def _serve_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            try:
                cmd = json.loads(line.decode() or "{}")
            except ValueError:
                cmd = {"prefix": line.decode().strip()}
            prefix = str(cmd.pop("prefix", ""))
            entry = self._commands.get(prefix)
            if entry is None:
                out = {"error": f"unknown command {prefix!r}; "
                       "try 'help'"}
            else:
                handler, _ = entry
                try:
                    result = handler(**cmd)
                    if inspect.isawaitable(result):
                        result = await result
                    out = result
                except Exception as e:  # surface, don't kill the server
                    log.derr("%s: admin command %r failed: %s",
                             self.entity, prefix, e)
                    out = {"error": f"{type(e).__name__}: {e}"}
            writer.write(json.dumps(out, default=str).encode() + b"\n")
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


async def admin_command(path: str, prefix: str, /, **args):
    """Client side of the protocol (the ``ceph daemon`` CLI leg)."""
    if "prefix" in args:
        # would silently replace the command being run
        raise ValueError("'prefix' is not a valid command argument")
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        writer.write(json.dumps({"prefix": prefix, **args}).encode()
                     + b"\n")
        await writer.drain()
        raw = await reader.readline()
        return json.loads(raw.decode() or "null")
    finally:
        writer.close()

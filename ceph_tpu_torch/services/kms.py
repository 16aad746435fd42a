"""KMS integration for RGW server-side encryption (SSE-KMS / SSE-S3).

Counterpart of ceph_tpu/services/kms.py: the same module over the
port's imports.

Reference: src/rgw/rgw_kms.h — RGW never stores master keys; it asks a
KMS backend (vault / kmip / testing) to wrap a fresh per-object data
key under a named, versioned master key, and stores only the wrapped
blob with the object (rgw_crypt.cc wiring).  Rotating a master key adds
a NEW version for future wraps; every old version is kept, so objects
wrapped before rotation still unwrap — the property the S3 API
guarantees and the tests pin.

Backends:
- ``ConfigKeyKMS``: master keys live in the monitor's config-key store
  (the reference's testing backend keeps them in ceph config likewise)
  under ``<prefix>/<key_id>/<version>``.
- ``LocalKMS``: in-process dict, for unit tests without a cluster.

Data keys are 32-byte AES-256 keys, wrapped with AES-256-GCM under the
master key (authenticated: a tampered blob fails loudly, it cannot
decrypt to garbage).
"""

from __future__ import annotations

import secrets


class KMSError(IOError):
    pass


def _wrap(master: bytes, plaintext: bytes) -> dict:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    nonce = secrets.token_bytes(12)
    ct = AESGCM(master).encrypt(nonce, plaintext, b"rgw-kms")
    return {"nonce": nonce.hex(), "ct": ct.hex()}


def _unwrap(master: bytes, blob: dict) -> bytes:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    try:
        return AESGCM(master).decrypt(
            bytes.fromhex(blob["nonce"]), bytes.fromhex(blob["ct"]),
            b"rgw-kms",
        )
    except (InvalidTag, ValueError, KeyError) as e:
        raise KMSError(f"data key unwrap failed: {e}") from e


class KMS:
    """Backend interface (rgw_kms.h RGWKMS role)."""

    async def create_key(self, key_id: str) -> None:
        raise NotImplementedError

    async def rotate_key(self, key_id: str) -> int:
        """Add a new master-key version; returns the new version."""
        raise NotImplementedError

    async def list_keys(self) -> list[str]:
        raise NotImplementedError

    async def generate_data_key(self, key_id: str
                                ) -> tuple[bytes, dict]:
        """-> (plaintext 32-byte data key, wrapped blob to store)."""
        raise NotImplementedError

    async def unwrap_data_key(self, key_id: str, wrapped: dict
                              ) -> bytes:
        raise NotImplementedError

    # shared wrap bookkeeping over backend-provided master storage
    async def _master(self, key_id: str, version: int) -> bytes:
        raise NotImplementedError

    async def _current_version(self, key_id: str,
                               create: bool = False) -> int:
        raise NotImplementedError


class _MasterKeyKMS(KMS):
    """Wrap/unwrap over any versioned master-key storage."""

    async def generate_data_key(self, key_id: str
                                ) -> tuple[bytes, dict]:
        version = await self._current_version(key_id, create=True)
        master = await self._master(key_id, version)
        dk = secrets.token_bytes(32)
        blob = _wrap(master, dk)
        blob["v"] = version
        blob["key_id"] = key_id
        return dk, blob

    async def unwrap_data_key(self, key_id: str, wrapped: dict
                              ) -> bytes:
        version = int(wrapped.get("v", 1))
        master = await self._master(key_id, version)
        return _unwrap(master, wrapped)


class LocalKMS(_MasterKeyKMS):
    """In-memory test backend."""

    def __init__(self):
        self._keys: dict[str, list[bytes]] = {}

    async def create_key(self, key_id: str) -> None:
        self._keys.setdefault(key_id, [secrets.token_bytes(32)])

    async def rotate_key(self, key_id: str) -> int:
        if key_id not in self._keys:
            raise KMSError(f"no such key {key_id!r}")
        self._keys[key_id].append(secrets.token_bytes(32))
        return len(self._keys[key_id])

    async def list_keys(self) -> list[str]:
        return sorted(self._keys)

    async def _master(self, key_id: str, version: int) -> bytes:
        versions = self._keys.get(key_id)
        if versions is None or not 1 <= version <= len(versions):
            raise KMSError(f"no key {key_id!r} v{version}")
        return versions[version - 1]

    async def _current_version(self, key_id: str,
                               create: bool = False) -> int:
        if key_id not in self._keys:
            if not create:
                raise KMSError(f"no such key {key_id!r}")
            await self.create_key(key_id)
        return len(self._keys[key_id])


class ConfigKeyKMS(_MasterKeyKMS):
    """Master keys in the monitor config-key store (the reference's
    testing backend keeps them in ceph config the same way):
    ``<prefix>/<key_id>/v<version>`` -> hex key material,
    ``<prefix>/<key_id>/current`` -> version number."""

    def __init__(self, rados, prefix: str = "rgw/crypt"):
        self.rados = rados
        self.prefix = prefix.rstrip("/")

    async def _get(self, key: str) -> str | None:
        r = await self.rados.mon_command("config-key get", key=key)
        if r["rc"] != 0:
            return None
        return r["data"]

    async def _set(self, key: str, value: str) -> None:
        r = await self.rados.mon_command("config-key set", key=key,
                                         value=value)
        if r["rc"] != 0:
            raise KMSError(f"config-key set {key!r} failed: {r}")

    async def create_key(self, key_id: str) -> None:
        cur = await self._get(f"{self.prefix}/{key_id}/current")
        if cur is not None:
            return
        await self._set(f"{self.prefix}/{key_id}/v1",
                        secrets.token_bytes(32).hex())
        await self._set(f"{self.prefix}/{key_id}/current", "1")

    async def rotate_key(self, key_id: str) -> int:
        cur = await self._get(f"{self.prefix}/{key_id}/current")
        if cur is None:
            raise KMSError(f"no such key {key_id!r}")
        nxt = int(cur) + 1
        await self._set(f"{self.prefix}/{key_id}/v{nxt}",
                        secrets.token_bytes(32).hex())
        await self._set(f"{self.prefix}/{key_id}/current", str(nxt))
        return nxt

    async def list_keys(self) -> list[str]:
        r = await self.rados.mon_command("config-key ls")
        if r["rc"] != 0:
            return []
        pre = self.prefix + "/"
        out = set()
        for k in r["data"]:
            if k.startswith(pre) and k.endswith("/current"):
                out.add(k[len(pre):-len("/current")])
        return sorted(out)

    async def _master(self, key_id: str, version: int) -> bytes:
        raw = await self._get(f"{self.prefix}/{key_id}/v{version}")
        if raw is None:
            raise KMSError(f"no key {key_id!r} v{version}")
        return bytes.fromhex(raw)

    async def _current_version(self, key_id: str,
                               create: bool = False) -> int:
        cur = await self._get(f"{self.prefix}/{key_id}/current")
        if cur is None:
            if not create:
                raise KMSError(f"no such key {key_id!r}")
            await self.create_key(key_id)
            return 1
        return int(cur)


class VaultKMS(_MasterKeyKMS):
    """HashiCorp-Vault KV-v2 backend (reference rgw_kms.cc
    VaultSecretEngine, rgw_crypt_vault_* options): master-key versions
    are KV-v2 secret versions under ``<mount>/data/<prefix>/<key_id>``
    with ``{"data": {"key": <hex>}}`` payloads, authenticated by the
    ``X-Vault-Token`` header.  Rotation writes a NEW secret version
    (Vault KV auto-increments); every old version stays readable with
    ``?version=N``, which is what keeps pre-rotation objects
    decryptable.  Speaks plain HTTP/1.1 over asyncio (the reference
    shells out to libcurl the same way)."""

    def __init__(self, addr: str, token: str,
                 mount: str = "secret", prefix: str = "rgw",
                 timeout: float = 5.0):
        self.addr = addr.rstrip("/")
        self.token = token
        self.mount = mount.strip("/")
        self.prefix = prefix.strip("/")
        self.timeout = timeout

    def _data_path(self, key_id: str) -> str:
        return f"/v1/{self.mount}/data/{self.prefix}/{key_id}"

    async def _request(self, method: str, path: str,
                       body: dict | None = None) -> tuple[int, dict]:
        import asyncio
        import json as _json
        import ssl as ssl_mod
        import urllib.parse

        u = urllib.parse.urlsplit(self.addr + path)
        host, port = u.hostname or "", u.port or 8200
        # production Vault is TLS-only: an https:// address MUST get a
        # TLS socket, or the X-Vault-Token would cross in cleartext
        ctx = ssl_mod.create_default_context() \
            if u.scheme == "https" else None
        payload = _json.dumps(body).encode() if body is not None \
            else b""
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, ssl=ctx),
                self.timeout)
            target = u.path + (f"?{u.query}" if u.query else "")
            req = (f"{method} {target} HTTP/1.1\r\n"
                   f"Host: {host}\r\n"
                   f"X-Vault-Token: {self.token}\r\n"
                   "Content-Type: application/json\r\n"
                   f"Content-Length: {len(payload)}\r\n"
                   "Connection: close\r\n\r\n").encode() + payload
            writer.write(req)
            await asyncio.wait_for(writer.drain(), self.timeout)
            status_line = await asyncio.wait_for(reader.readline(),
                                                self.timeout)
            status = int(status_line.split()[1])
            length = None
            chunked = False
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              self.timeout)
                if not line or line == b"\r\n":
                    break
                low = line.lower()
                if low.startswith(b"content-length:"):
                    length = int(line.split(b":")[1])
                elif low.startswith(b"transfer-encoding:") and \
                        b"chunked" in low:
                    chunked = True
            if chunked:
                # real Vault (Go net/http) chunks larger responses;
                # treating them as empty would turn existing keys
                # into 'malformed vault secret' errors
                raw = b""
                while True:
                    szline = await asyncio.wait_for(
                        reader.readline(), self.timeout)
                    size = int(szline.split(b";")[0], 16)
                    if size == 0:
                        await asyncio.wait_for(reader.readline(),
                                               self.timeout)
                        break
                    raw += await asyncio.wait_for(
                        reader.readexactly(size), self.timeout)
                    await asyncio.wait_for(reader.readexactly(2),
                                           self.timeout)
            elif length:
                raw = await asyncio.wait_for(
                    reader.readexactly(length), self.timeout)
            elif length is None:
                # Connection: close with neither header: body runs
                # to EOF
                raw = await asyncio.wait_for(reader.read(),
                                             self.timeout)
            else:
                raw = b"{}"
            try:
                return status, _json.loads(raw or b"{}")
            except ValueError:
                return status, {}
        except (OSError, ValueError, IndexError,
                asyncio.TimeoutError) as e:
            raise KMSError(f"vault {method} {path}: {e}") from e
        finally:
            if writer is not None:
                writer.close()
                try:
                    await writer.wait_closed()
                except OSError:
                    pass

    async def create_key(self, key_id: str) -> None:
        status, _ = await self._request("GET", self._data_path(key_id))
        if status == 200:
            return                      # already exists
        if status == 403:
            raise KMSError("vault permission denied")
        if status != 404:
            raise KMSError(f"vault answered {status}")
        status, _ = await self._request(
            "POST", self._data_path(key_id),
            {"data": {"key": secrets.token_bytes(32).hex()}})
        if status not in (200, 204):
            raise KMSError(f"vault key create answered {status}")

    async def rotate_key(self, key_id: str) -> int:
        status, out = await self._request("GET",
                                          self._data_path(key_id))
        if status != 200:
            raise KMSError(f"no such key {key_id!r} ({status})")
        status, out = await self._request(
            "POST", self._data_path(key_id),
            {"data": {"key": secrets.token_bytes(32).hex()}})
        if status not in (200, 204):
            raise KMSError(f"vault rotate answered {status}")
        return int(out.get("data", {}).get("version", 0))

    async def list_keys(self) -> list[str]:
        status, out = await self._request(
            "LIST", f"/v1/{self.mount}/metadata/{self.prefix}")
        if status != 200:
            return []
        return sorted(out.get("data", {}).get("keys", ()))

    async def _master(self, key_id: str, version: int) -> bytes:
        status, out = await self._request(
            "GET", self._data_path(key_id) + f"?version={version}")
        if status != 200:
            raise KMSError(f"no key {key_id!r} v{version} ({status})")
        try:
            return bytes.fromhex(out["data"]["data"]["key"])
        except (KeyError, ValueError) as e:
            raise KMSError(f"malformed vault secret: {e}") from e

    async def _current_version(self, key_id: str,
                               create: bool = False) -> int:
        status, out = await self._request("GET",
                                          self._data_path(key_id))
        if status != 200:
            if not create:
                raise KMSError(f"no such key {key_id!r}")
            await self.create_key(key_id)
            status, out = await self._request(
                "GET", self._data_path(key_id))
            if status != 200:
                raise KMSError(f"vault key create raced ({status})")
        try:
            return int(out["data"]["metadata"]["version"])
        except (KeyError, ValueError) as e:
            raise KMSError(f"malformed vault secret: {e}") from e

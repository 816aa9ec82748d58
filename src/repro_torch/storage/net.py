"""Multi-host network layer for the DMS (paper S4.1's RDMA transport).

The paper's DataSpaces deployment keeps payload blocks on their home
servers and moves bytes between hosts over an RDMA transport; this module
is the TCP equivalent, implementing the same :class:`~repro_torch.storage.dms.
Transport` message API as :class:`~repro_torch.storage.dms.InProcTransport` so
the two are drop-in swaps under :class:`~repro_torch.storage.dms.
DistributedMemoryStorage` (and therefore under the DMS tier of a
:class:`~repro_torch.storage.tiers.TieredStore`).

Wire protocol (one request/response round-trip per message)::

    frame    := u32 header_len | u64 payload_len | header | payload
    header   := JSON (op, sid, key/coord/bb/home..., array meta)
    payload  := block bytes (C order, little-endian), only for store
                requests and fetch / fetch_many responses.
                fetch_many: per-block buffers back to back, each block's
                byte offset in its header entry ("off"/"len"; legacy
                servers omit them and the client falls back to
                cumulative raw sizes).  The server sends the buffers
                with one scatter-IO ``sendmsg`` — they are never
                concatenated in memory.

Array payloads travel as ``header {shape, dtype} + raw buffer`` — no
pickling, dtype and shape preserved bit-exact (including float16 /
bfloat16 / empty arrays; non-contiguous inputs are compacted once on the
sending side).  Optionally the buffer is compressed by one of the
``storage/codec.py`` codecs (a ``codec`` tag in the array header makes
every block self-describing) and/or replaced entirely by a
shared-memory reference (``"shm": [offset, nbytes]``) when client and
server negotiated a same-host arena — see ``storage/shm.py``.

Negotiation: a client constructed with ``wire_codec=`` or ``shm=`` sends
one ``hello`` frame per connection before its first message.  The reply
carries the server's supported codecs and (when requested and available)
its arena descriptor ``{name, size, token}``.  An old server rejects
``hello`` as an unknown op and the client silently falls back to the
plain wire format, so mixed-version fleets interoperate; a client
without those options never sends ``hello`` and is byte-identical to the
legacy protocol.

Pieces:
  * :class:`SocketTransport` — the client: one pipelined TCP connection
    per server endpoint, thread-safe, every wire byte accounted in
    ``TransportStats`` (raw vs wire bytes split).
  * :class:`ShmTransport` — a :class:`SocketTransport` that requires the
    shared-memory data plane (co-located fleets; control frames on the
    socket, payloads through the arena).
  * :class:`ServerProcess` — a subprocess handle that runs ``python -m
    repro_torch.storage.net`` hosting one or more ``_Server`` shards behind a
    threaded socket loop (the standalone entry point documented in the
    README).
  * :func:`spawn_servers` — convenience: start N shards across M
    processes and hand back a :class:`ServerGroup` with the endpoint
    list, ready for ``SocketTransport``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import socket
import socketserver
import struct
import subprocess
import sys
import threading
import time
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey
from repro_torch.storage.codec import (  # noqa: F401 — array codec re-exported
    WIRE_CODECS,
    Encoded,
    check_codec,
    codec_names,
    decode_array,  # noqa: F401
    decode_block,
    encode_array,  # noqa: F401
    encode_block,
    is_lossless,
    raw_nbytes,
    resolve_codec,
)
from repro_torch.storage.disk import _bb_from_json, _bb_to_json, _key_from_json, _key_to_json
from repro_torch.storage.dms import (  # noqa: F401 — TransportError re-exported
    META_MSG_BYTES,
    TransportError,
    TransportStats,
    _Server,
    decode_homes,
    encode_homes,
)
from repro_torch.storage.shm import ShmArena, ShmWindow

_PREFIX = struct.Struct("!IQ")  # header_len, payload_len

# default arena capacity for shard hosts (created lazily on the first
# shm-negotiating hello, so plain fleets never touch /dev/shm)
DEFAULT_ARENA_BYTES = 256 << 20


def _homes_json(home):
    """``home`` directory field for the wire: a bare int stays a bare int
    (the legacy single-home format, byte-for-byte), a replica sequence
    becomes a JSON list.  The server stores it as sent; lookup returns it
    as stored.  One source of truth: the dms codec pair."""
    return encode_homes(decode_homes(home))


# ---------------------------------------------------------------------------
# framing + array codec
# ---------------------------------------------------------------------------
def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise TransportError("connection closed mid-frame")
        got += r
    return buf


def _nbytes(buf) -> int:
    return buf.nbytes if isinstance(buf, memoryview) else len(buf)


_IOV_CHUNK = 64  # comfortably under IOV_MAX (1024 on linux)


def _sendmsg_all(sock: socket.socket, parts: list) -> None:
    """Scatter-IO sendall: put every buffer on the wire without ever
    concatenating them (``sendmsg`` io-vectors + partial-send loop)."""
    bufs = [memoryview(p).cast("B") for p in parts]
    bufs = [b for b in bufs if b.nbytes]
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_CHUNK])
        if sent <= 0:
            raise OSError("sendmsg returned no progress")
        while bufs and sent:
            if sent >= bufs[0].nbytes:
                sent -= bufs[0].nbytes
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0


def send_frame_parts(sock: socket.socket, header: dict, parts: Sequence) -> int:
    """Send one frame whose payload is ``parts`` back to back; returns
    the number of bytes put on the wire."""
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    plen = sum(_nbytes(p) for p in parts)
    _sendmsg_all(sock, [_PREFIX.pack(len(hbytes), plen), hbytes, *parts])
    return _PREFIX.size + len(hbytes) + plen


def send_frame(sock: socket.socket, header: dict, payload=b"") -> int:
    """Send one frame; returns the number of bytes put on the wire."""
    return send_frame_parts(sock, header, (payload,))


def recv_frame(sock: socket.socket) -> tuple[dict, bytearray, int]:
    """Receive one frame; returns (header, payload, wire_bytes)."""
    hlen, plen = _PREFIX.unpack(bytes(_recv_exact(sock, _PREFIX.size)))
    header = json.loads(bytes(_recv_exact(sock, hlen)))
    payload = _recv_exact(sock, plen) if plen else bytearray()
    return header, payload, _PREFIX.size + hlen + plen


# The array codec itself (encode_array/decode_array + the compressing
# encode_block/decode_block) lives in ``storage/codec.py`` and is
# re-exported above: net.py owns framing, codec.py owns payload bytes.


# ---------------------------------------------------------------------------
# client: SocketTransport
# ---------------------------------------------------------------------------
def _parse_endpoint(ep) -> tuple[str, int]:
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        return host or "127.0.0.1", int(port)
    host, port = ep
    return str(host), int(port)


_SCOPE_SEP = "\x1f"  # unit separator: cannot appear in a sane namespace


class SocketTransport:
    """Transport over framed TCP to one or more :class:`ServerProcess`es.

    ``endpoints[i]`` is the address serving global server id ``i``; the
    same address may appear for several ids when one process hosts
    multiple shards.  One connection per distinct address, guarded by a
    lock (requests to the same host serialize; different hosts proceed
    concurrently).  A failed connection is dropped and re-dialed on the
    next message, so a restarted server becomes reachable again — but the
    failing message itself surfaces as :class:`TransportError`.

    ``scope`` isolates keyspaces on a *shared* server fleet: every key is
    namespace-prefixed on the wire and filtered/stripped on the way back,
    so several stores (e.g. the WSI pipeline's DMS3 + DMS2) can share one
    fleet without ``query``/``delete`` cross-contamination — matching the
    isolation that separate ``InProcTransport`` instances give for free.
    (``payload_bytes`` stays physical: it reports the server's total
    resident bytes across scopes.)

    Liveness: a request failure marks the endpoint dead for
    ``dead_backoff`` seconds.  The first request after a failure (and
    after each backoff expiry) sends one short ``ping`` probe
    (``probe_timeout``) — so a transient blip recovers on the very next
    request — while requests between a FAILED probe and its backoff
    expiry fail fast with :class:`TransportError` instead of re-paying a
    connect/op timeout, which is what keeps the DMS's replica failover
    cheap.  ``alive()`` exposes the cache so routing can prefer live
    replicas up front.

    Data-plane options (all default OFF — the plain transport is
    byte-identical to the legacy wire format and never sends ``hello``):

      * ``wire_codec`` — compress payload blocks on the wire with one of
        ``codec.WIRE_CODECS`` ("zlib" lossless; "bf16"/"int8" lossy for
        float blocks, lossless-zlib fallback otherwise).  Negotiated per
        connection; an old server degrades the link to raw.  A *mapping*
        is a per-key override table — glob patterns over region keys
        (``{"labels/*": "zlib", "feat/*": "bf16"}``, first hit wins, no
        hit means raw) — so label tiles and float features each get
        their best codec on ONE connection.  Per-key tagging inside a
        single ``fetch_many`` needs a server that advertises the ``pkc``
        capability; older servers serve the map per request (store/
        fetch) and raw gathers.
      * ``shm`` — ``"off"`` | ``"auto"`` | ``"require"``: map the
        server's shared-memory arena when co-located so fetch payloads
        arrive by ``(offset, nbytes)`` reference instead of a TCP
        stream.  ``auto`` silently falls back to socket payloads (remote
        host, old server, no arena); ``require`` raises
        :class:`TransportError` when any endpoint cannot negotiate it.
      * ``zero_copy`` — shm fetches return read-only views directly into
        the mapped arena (RDMA-window semantics: valid until the block
        is dropped or overwritten server-side) instead of copying out.
    """

    def __init__(
        self,
        endpoints: Sequence,
        *,
        connect_timeout: float = 10.0,
        op_timeout: float = 120.0,
        scope: str | None = None,
        dead_backoff: float = 2.0,
        probe_timeout: float = 1.0,
        wire_codec: str | None = None,
        shm: str = "off",
        zero_copy: bool = False,
    ) -> None:
        self.endpoints = [_parse_endpoint(e) for e in endpoints]
        if not self.endpoints:
            raise ValueError("SocketTransport needs at least one endpoint")
        if shm not in ("off", "auto", "require"):
            raise ValueError(f"shm must be 'off', 'auto' or 'require', got {shm!r}")
        self.scope = scope
        self.num_servers = len(self.endpoints)
        self.stats = TransportStats()
        self.connect_timeout = connect_timeout
        self.op_timeout = op_timeout
        self.dead_backoff = dead_backoff
        self.probe_timeout = probe_timeout
        self.wire_codec = check_codec(wire_codec)
        self.shm = shm
        self.zero_copy = zero_copy
        self._conns: dict[tuple[str, int], socket.socket] = {}
        self._conn_locks: dict[tuple[str, int], threading.Lock] = {
            addr: threading.Lock() for addr in set(self.endpoints)
        }
        # per-connection negotiation outcome: {"codec": str|None,
        # "codecs": set, "pkc": bool, "window": ShmWindow|None};
        # absent until the first dial
        self._neg: dict[tuple[str, int], dict] = {}
        self._dead: dict[tuple[str, int], float] = {}  # addr -> retry-at (monotonic)
        self._probe_failed: set[tuple[str, int]] = set()  # probed dead this window
        self._removed: set[int] = set()  # sids torn down by remove_endpoint
        self._ep_lock = threading.Lock()  # guards endpoint-table mutation
        self._closed = False
        self._stats_lock = threading.Lock()
        self._elapsed = 0.0
        self._busy_until = 0.0  # interval-union bookkeeping for virtual_time

    # -- elastic membership ---------------------------------------------------------
    def add_endpoint(self, endpoint, *, sid: "int | None" = None) -> int:
        """Register one more server address live and return its sid.
        Re-adding a removed sid (same or new address) revives it; the
        liveness cache for the address is cleared so the newcomer is
        probed, not served a stale-dead answer."""
        addr = _parse_endpoint(endpoint)
        with self._ep_lock:
            if sid is None:
                sid = len(self.endpoints)
            for gap in range(len(self.endpoints), sid):
                # a skipped-ahead sid leaves placeholder slots behind it;
                # sids are table indices, so mark the gap absent — ops on
                # it fail fast instead of dialing the newcomer's address
                self._removed.add(gap)
            while len(self.endpoints) <= sid:
                self.endpoints.append(addr)
            self.endpoints[sid] = addr
            self._conn_locks.setdefault(addr, threading.Lock())
            self._removed.discard(sid)
            self.num_servers = len(self.endpoints)
        self.reset_liveness(sid)
        return sid

    def remove_endpoint(self, sid: int) -> None:
        """Tear down a departed server's path: its sid keeps its slot in
        the endpoint table (sids are indices — survivors must not shift)
        but every subsequent op fails fast with TransportError."""
        with self._ep_lock:
            self._removed.add(sid)
            addr = self.endpoints[sid]
            last = not any(
                self.endpoints[i] == addr
                for i in range(len(self.endpoints))
                if i not in self._removed
            )
        if last:
            # last sid on that address: drop the connection too (outside
            # _ep_lock — the connection lock must never nest under it)
            lock = self._conn_locks.get(addr)
            if lock is not None and lock.acquire(timeout=1.0):
                try:
                    self._drop_connection(addr)
                finally:
                    lock.release()

    def reset_liveness(self, server: int) -> None:
        """Forget cached deadness for the server's address and force a
        re-dial (+ re-negotiation) on the next request — the epoch-bump
        probe that keeps a leave/rejoin on the same port within the
        backoff window from being served stale-dead answers."""
        addr = self._addr_of(server)
        self._dead.pop(addr, None)
        self._probe_failed.discard(addr)
        lock = self._conn_locks.get(addr)
        if lock is not None and lock.acquire(timeout=1.0):
            try:
                self._drop_connection(addr)
            finally:
                lock.release()

    def known_servers(self) -> list[int]:
        """Every sid a frame could still reach (removed ones excluded)."""
        with self._ep_lock:
            return [i for i in range(len(self.endpoints)) if i not in self._removed]

    def _addr_of(self, server: int) -> tuple[str, int]:
        """Endpoint snapshot under the membership lock — the table can
        be grown (add_endpoint) or retired (remove_endpoint) from other
        threads mid-read."""
        with self._ep_lock:
            return self.endpoints[server]

    # -- connection management ----------------------------------------------------
    def _connection(self, addr: tuple[str, int]) -> socket.socket:
        sock = self._conns.get(addr)
        if sock is not None:
            return sock
        try:
            sock = socket.create_connection(addr, timeout=self.connect_timeout)
        except OSError as e:
            self._dead[addr] = time.monotonic() + self.dead_backoff
            self._probe_failed.discard(addr)
            raise TransportError(f"cannot reach DMS server at {addr[0]}:{addr[1]}: {e}") from e
        sock.settimeout(self.op_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.wire_codec or self.shm != "off":
            try:
                self._negotiate(addr, sock)
            except (OSError, TransportError):
                sock.close()
                raise
        self._conns[addr] = sock
        return sock

    def _negotiate(self, addr: tuple[str, int], sock: socket.socket) -> None:
        """One ``hello`` round-trip on a fresh connection.

        Establishes the wire codec and (when requested) maps the
        server's shm arena.  An old server rejects the unknown op —
        that degrades the link to the plain wire format rather than
        failing it, so new clients keep working against old fleets.
        """
        self._close_window(addr)
        hello = {"op": "hello", "shm": self.shm != "off"}
        needed = codec_names(self.wire_codec)
        if needed:
            hello["codecs"] = needed
        wire = send_frame(sock, hello)
        rheader, _, rwire = recv_frame(sock)
        self._account("meta", wire + rwire)
        neg = {"codec": None, "codecs": set(), "pkc": False, "window": None}
        if rheader.get("ok"):
            supported = set(rheader.get("codecs", ()))
            neg["codecs"] = {c for c in needed if c in supported}
            neg["pkc"] = bool(rheader.get("pkc"))
            if (
                isinstance(self.wire_codec, str)
                and self.wire_codec in neg["codecs"]
            ):
                neg["codec"] = self.wire_codec
            desc = rheader.get("shm")
            if desc:
                neg["window"] = ShmWindow.attach(desc)
        if self.shm == "require" and neg["window"] is None:
            raise TransportError(
                f"shm='require' but server at {addr[0]}:{addr[1]} could not "
                "negotiate a same-host arena (old server, remote host, or no "
                "arena configured)"
            )
        self._neg[addr] = neg

    def _close_window(self, addr: tuple[str, int]) -> None:
        neg = self._neg.pop(addr, None)
        if neg and neg.get("window") is not None:
            neg["window"].close()

    def _drop_connection(self, addr: tuple[str, int]) -> None:
        sock = self._conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        # negotiation state is per-connection: a re-dial re-negotiates
        # (the server may have restarted with a brand-new arena)
        self._close_window(addr)

    # -- liveness cache -------------------------------------------------------------
    def alive(self, server: int) -> bool:
        """Cheap cache read (no network): False while the endpoint's last
        failure is inside its ``dead_backoff`` window (or the sid was
        removed from the fleet)."""
        with self._ep_lock:
            if server in self._removed:
                return False
            addr = self.endpoints[server]
        until = self._dead.get(addr)
        return until is None or time.monotonic() >= until

    def _probe(self, addr: tuple[str, int]) -> bool:
        """Short-timeout ping on a throwaway connection: cheaper than
        paying a full op timeout to rediscover a still-dead host."""
        try:
            with socket.create_connection(addr, timeout=self.probe_timeout) as s:
                s.settimeout(self.probe_timeout)
                send_frame(s, {"op": "ping", "sid": -1})
                recv_frame(s)
            return True
        except (OSError, TransportError):
            return False

    def _check_liveness(self, server: int, addr: tuple[str, int], op) -> None:
        """One cheap ping probe per failure / backoff window, fail fast
        in between.  Probing on the FIRST retry after a failure (not
        only once the backoff expires) means a transient blip on a
        block's last live replica costs one probe, not ``dead_backoff``
        seconds of failed reads; a genuinely dead host still costs at
        most one probe per window."""
        until = self._dead.get(addr)
        if until is None:
            return
        now = time.monotonic()
        if now < until and addr in self._probe_failed:
            raise TransportError(
                f"DMS server {server} at {addr[0]}:{addr[1]} marked dead for "
                f"another {until - now:.1f}s (liveness backoff); {op!r} not sent"
            )
        if not self._probe(addr):
            self._probe_failed.add(addr)
            self._dead[addr] = time.monotonic() + self.dead_backoff
            raise TransportError(
                f"DMS server {server} at {addr[0]}:{addr[1]} still unreachable "
                f"(ping probe failed); backing off {self.dead_backoff:.1f}s"
            )
        self._dead.pop(addr, None)
        self._probe_failed.discard(addr)

    def _codec_for(self, neg: "dict | None", key) -> "str | None":
        """The negotiated codec this request should use: per-key
        resolution for mapping specs (only codecs the server supports),
        the single negotiated codec otherwise."""
        if neg is None:
            return None
        if isinstance(self.wire_codec, Mapping):
            if key is None:
                return None
            c = resolve_codec(self.wire_codec, key)
            return c if c in neg["codecs"] else None
        return neg["codec"]

    def _request(
        self,
        server: int,
        header: dict,
        payload=b"",
        *,
        encode_arr=None,
        data_plane=False,
        codec_key=None,
    ) -> tuple[dict, bytearray, int]:
        with self._ep_lock:
            if server in self._removed:
                raise TransportError(
                    f"server {server} has left the fleet; {header.get('op')!r} refused"
                )
            addr = self.endpoints[server]
        t0 = time.perf_counter()
        with self._conn_locks[addr]:
            if self._closed:
                raise TransportError(
                    f"transport is closed; {header.get('op')!r} to server "
                    f"{server} refused"
                )
            self._check_liveness(server, addr, header.get("op"))
            sock = self._connection(addr)
            # negotiation outcome is per-connection, so the request's
            # data-plane fields can only be filled in once the dial (and
            # hello) above has happened
            neg = self._neg.get(addr)
            if data_plane and neg is not None:
                codec = self._codec_for(neg, codec_key)
                if codec:
                    header["codec"] = codec
                if neg["window"] is not None:
                    header["shm"] = True
            if encode_arr is not None:
                meta, payload = encode_block(encode_arr, self._codec_for(neg, codec_key))
                header["array"] = meta
            try:
                wire = send_frame(sock, header, payload)  # relint: allow(blocking-under-lock) — the per-connection lock IS the wire serialization: one request owns the socket for its full round-trip
                rheader, rpayload, rwire = recv_frame(sock)  # relint: allow(blocking-under-lock) — paired with the send above; interleaved frames would corrupt the stream
            except (OSError, TransportError) as e:
                self._drop_connection(addr)
                # fresh failure: dead-marked, but the next request earns
                # one probe (see _check_liveness) — a blip must not cost
                # the whole backoff window
                self._dead[addr] = time.monotonic() + self.dead_backoff
                self._probe_failed.discard(addr)
                raise TransportError(
                    f"DMS server {server} at {addr[0]}:{addr[1]} failed during "
                    f"{header.get('op')!r}: {e}"
                ) from e
        t1 = time.perf_counter()
        with self._stats_lock:
            # union of in-flight intervals: concurrent requests to
            # different hosts must not double-count wall time
            start = max(t0, self._busy_until)
            if t1 > start:
                self._elapsed += t1 - start
                self._busy_until = t1
        if not rheader.get("ok"):
            if rheader.get("etype") == "KeyError":
                raise KeyError(rheader.get("msg", "remote KeyError"))
            raise TransportError(
                f"server {server} rejected {header.get('op')!r}: "
                f"{rheader.get('etype')}: {rheader.get('msg')}"
            )
        return rheader, rpayload, wire + rwire

    def _scoped(self, key: RegionKey) -> RegionKey:
        if not self.scope:
            return key
        return dataclasses.replace(
            key, namespace=self.scope + _SCOPE_SEP + key.namespace
        )

    def _unscoped(self, key: RegionKey) -> RegionKey | None:
        """Strip the scope prefix; None for keys outside this scope."""
        if not self.scope:
            return key
        prefix = self.scope + _SCOPE_SEP
        if not key.namespace.startswith(prefix):
            return None
        return dataclasses.replace(key, namespace=key.namespace[len(prefix):])

    def _account(self, op: str, nbytes: int, raw: int | None = None, shm_blocks: int = 0) -> None:
        if op == "put":
            self.stats.add(
                puts=1, bytes_put=nbytes, bytes_put_raw=nbytes if raw is None else raw
            )
        elif op == "get":
            self.stats.add(
                gets=1,
                bytes_get=nbytes,
                bytes_get_raw=nbytes if raw is None else raw,
                shm_gets=shm_blocks,
            )
        else:
            self.stats.add(meta_msgs=1, bytes_meta=nbytes)

    def _window(self, server: int) -> ShmWindow | None:
        neg = self._neg.get(self._addr_of(server))
        return neg["window"] if neg else None

    def _read_shm(self, server: int, meta: dict) -> np.ndarray:
        window = self._window(server)
        if window is None:
            # a reply can only carry an shm ref when this client asked
            # for one on this connection — a missing window is a bug or
            # a torn re-dial, not a protocol state
            raise TransportError(
                f"server {server} replied with an shm reference but no "
                "arena window is mapped on this connection"
            )
        return window.read(int(meta["shm"][0]), meta, zero_copy=self.zero_copy)

    # -- Transport message API -----------------------------------------------------
    def store(self, server, key, block_coord, box, payload) -> None:
        arr = np.asarray(payload)
        header = {
            "op": "store",
            "sid": server,
            "key": _key_to_json(self._scoped(key)),
            "coord": list(block_coord),
            "bb": _bb_to_json(box),
        }
        # the payload is encoded inside _request once the connection's
        # negotiated codec is known (stores always ride the socket; the
        # server places them into its arena for later shm fetches)
        _, _, wire = self._request(server, header, encode_arr=arr, codec_key=key)
        self._account("put", wire, raw=arr.nbytes)

    def fetch(self, server, key, block_coord) -> np.ndarray:
        header = {
            "op": "fetch",
            "sid": server,
            "key": _key_to_json(self._scoped(key)),
            "coord": list(block_coord),
        }
        rheader, rpayload, wire = self._request(
            server, header, data_plane=True, codec_key=key
        )
        meta = rheader["array"]
        if "shm" in meta:
            arr = self._read_shm(server, meta)
            self._account("get", wire, raw=arr.nbytes, shm_blocks=1)
            return arr
        arr = decode_block(meta, rpayload)
        self._account("get", wire, raw=arr.nbytes)
        return arr

    def fetch_many(self, server, requests) -> list[np.ndarray]:
        """Scatter-gather fetch: N blocks in ONE round-trip.

        The response header carries per-block {shape, dtype, off, len}
        metadata; each block decodes straight out of the single receive
        buffer at its stated offset (shm-resident blocks carry an
        ``shm`` arena reference instead and skip the socket payload
        entirely).  Legacy servers omit the offsets — the client falls
        back to cumulative raw sizes in request order.
        """
        if not requests:
            return []
        per_key = isinstance(self.wire_codec, Mapping)
        if per_key:
            # per-request codec tags ride in the reqs themselves when the
            # server negotiated the pkc capability; _request leaves the
            # top-level codec unset for mapping specs, and against an old
            # server the tags below are filtered out (raw gather)
            neg = self._neg.get(self._addr_of(server))
            reqs = [
                [
                    _key_to_json(self._scoped(key)),
                    list(coord),
                    self._codec_for(neg, key) if neg and neg["pkc"] else None,
                ]
                for key, coord in requests
            ]
            if not (neg and neg["pkc"]):
                reqs = [r[:2] for r in reqs]
        else:
            reqs = [
                [_key_to_json(self._scoped(key)), list(coord)]
                for key, coord in requests
            ]
        header = {"op": "fetch_many", "sid": server, "reqs": reqs}
        rheader, rpayload, wire = self._request(server, header, data_plane=True)
        out: list[np.ndarray] = []
        view = memoryview(rpayload)
        cursor = 0
        shm_blocks = 0
        for meta in rheader["arrays"]:
            if "shm" in meta:
                out.append(self._read_shm(server, meta))
                shm_blocks += 1
                continue
            if "off" in meta:
                off, n = int(meta["off"]), int(meta["len"])
            else:  # legacy server: raw buffers back to back, no offsets
                off, n = cursor, raw_nbytes(meta)
                cursor = off + n
            out.append(decode_block(meta, view[off : off + n]))
        self._account(
            "get", wire, raw=sum(a.nbytes for a in out), shm_blocks=shm_blocks
        )
        return out

    def put_meta(self, server, key, block_coord, box, home) -> None:
        header = {
            "op": "put_meta",
            "sid": server,
            "key": _key_to_json(self._scoped(key)),
            "coord": list(block_coord),
            "bb": _bb_to_json(box),
            "home": _homes_json(home),
        }
        self._request(server, header)
        self._account("meta", META_MSG_BYTES)

    def put_meta_batch(self, server, entries) -> "list[tuple] | None":
        """One frame carrying every directory record of a put — N
        round-trips per put instead of blocks x N.  The response's
        ``had`` field lists the coords that already had an entry (the
        rollback pre-image); None when the server predates it."""
        header = {
            "op": "put_meta_batch",
            "sid": server,
            "entries": [
                [
                    _key_to_json(self._scoped(key)),
                    list(coord),
                    _bb_to_json(box),
                    _homes_json(home),
                ]
                for key, coord, box, home in entries
            ],
        }
        rheader, _, wire = self._request(server, header)
        # one wire frame, len(entries) logical directory records
        self.stats.add(meta_msgs=len(entries), bytes_meta=wire)
        had = rheader.get("had")
        return None if had is None else [tuple(c) for c in had]

    def lookup(self, server, key) -> dict[tuple, tuple[BoundingBox, int]]:
        header = {"op": "lookup", "sid": server, "key": _key_to_json(self._scoped(key))}
        rheader, _, wire = self._request(server, header)
        self._account("meta", wire)
        return {
            tuple(coord): (_bb_from_json(bb), home)
            for coord, bb, home in rheader["blocks"]
        }

    def keys(self, server) -> list[RegionKey]:
        rheader, _, wire = self._request(server, {"op": "keys", "sid": server})
        self._account("meta", wire)
        decoded = (self._unscoped(_key_from_json(k)) for k in rheader["keys"])
        return [k for k in decoded if k is not None]

    def drop(self, server, key) -> None:
        self._request(
            server, {"op": "drop", "sid": server, "key": _key_to_json(self._scoped(key))}
        )
        self._account("meta", META_MSG_BYTES)

    def drop_block(self, server, key, block_coord) -> None:
        """Per-block drop (payload + directory entry): the put-rollback
        primitive — a whole-key ``drop`` would destroy sibling blocks."""
        self._request(
            server,
            {
                "op": "drop_block",
                "sid": server,
                "key": _key_to_json(self._scoped(key)),
                "coord": list(block_coord),
            },
        )
        self._account("meta", META_MSG_BYTES)

    def payload_bytes(self, server) -> int:
        rheader, _, _ = self._request(server, {"op": "payload_bytes", "sid": server})
        return int(rheader["nbytes"])

    def join(self, server: int, sid: int, view: dict) -> "dict | None":
        """Announce ``sid``'s join under the given RingView JSON; the
        host adopts it if newer and returns the view it now holds."""
        rheader, _, wire = self._request(
            server, {"op": "join", "sid": server, "member": sid, "view": view}
        )
        self._account("meta", wire)
        return rheader.get("view")

    def leave(self, server: int, sid: int, view: dict, purge: bool = False) -> "dict | None":
        """Announce ``sid``'s leave; ``purge=True`` (sent to the host of
        the departed shard once the drain finished) also clears that
        shard's payload, directory, and arena slots."""
        header = {
            "op": "leave",
            "sid": server,
            "member": sid,
            "view": view,
            "purge": bool(purge),
        }
        rheader, _, wire = self._request(server, header)
        self._account("meta", wire)
        return rheader.get("view")

    def epoch(self, server: int) -> "dict | None":
        """The fleet view this host currently holds (RingView JSON), or
        None when it was never told one."""
        rheader, _, wire = self._request(server, {"op": "epoch", "sid": server})
        self._account("meta", wire)
        return rheader.get("view")

    def gen(self, server: int, bump=None, want=None) -> dict:
        """Write-generation gossip: bump/read per-key fleet counters on
        ``server``'s shard (see :meth:`Transport.gen`)."""
        header = {
            "op": "gen",
            "sid": server,
            "bump": list(bump or ()),
            "want": list(want or ()),
        }
        rheader, _, wire = self._request(server, header)
        self._account("meta", wire)
        return dict(rheader.get("gens") or {})

    def ping(self, server: int) -> list[int]:
        """Liveness probe; returns the shard ids the endpoint hosts."""
        rheader, _, _ = self._request(server, {"op": "ping", "sid": server})
        return list(rheader.get("sids", []))

    # -- lifecycle / accounting ------------------------------------------------------
    def virtual_time(self) -> float:
        """Measured wall seconds during which at least one request was on
        the wire (keeps ``aggregate_throughput`` meaningful over real
        sockets, including multi-threaded clients)."""
        with self._stats_lock:
            return self._elapsed

    def reset(self) -> None:
        with self._stats_lock:
            self.stats.reset()
            self._elapsed = 0.0
            self._busy_until = 0.0

    def close(self) -> None:
        # refuse new requests, then close each connection under its lock
        # so an in-flight _request finishes its frame first.  The wait is
        # bounded: a request stuck in recv on a hung host must not stall
        # shutdown for its full op_timeout — after the grace period the
        # socket is closed anyway, and the stuck recv's OSError is still
        # wrapped into TransportError by _request (never a raw mid-frame
        # error reaching the caller)
        self._closed = True
        for addr, lock in list(self._conn_locks.items()):
            acquired = lock.acquire(timeout=1.0)
            try:
                self._drop_connection(addr)
            finally:
                if acquired:
                    lock.release()


class ShmTransport(SocketTransport):
    """A :class:`SocketTransport` that requires the shared-memory data
    plane: control frames on the socket, fetch payloads through the
    server's mapped arena.  Construction fails fast (on first use of an
    endpoint) with :class:`TransportError` when the fleet is not
    co-located or predates arenas — use ``SocketTransport(shm="auto")``
    for opportunistic zero-copy that degrades to the stream."""

    def __init__(self, endpoints: Sequence, **kw) -> None:
        kw.setdefault("shm", "require")
        super().__init__(endpoints, **kw)


# ---------------------------------------------------------------------------
# server: _Server shards behind a threaded socket loop
# ---------------------------------------------------------------------------
class _NetServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        address: tuple[str, int],
        sids: Iterable[int],
        *,
        arena_bytes: int = DEFAULT_ARENA_BYTES,
        at_rest: bool = False,
    ) -> None:
        self.shards: dict[int, _Server] = {int(s): _Server(int(s)) for s in sids}
        self.arena_bytes = int(arena_bytes)
        self.at_rest = bool(at_rest)
        self.arena: ShmArena | None = None
        self._arena_lock = threading.Lock()
        # fleet membership view (RingView JSON) adopted via join/leave
        # announcements: highest epoch wins, served back on every
        # membership op so any client/server can catch up from any peer
        self.fleet_view: dict | None = None
        self._view_lock = threading.Lock()
        # REPRO_NET_COMPAT=1 makes this process behave like a pre-codec
        # server (hello is an unknown op, every payload raw) — the
        # mixed-fleet compatibility tests run against the real code path
        # new clients hit on old fleets, not a mock
        self.compat = os.environ.get("REPRO_NET_COMPAT", "") not in ("", "0")
        super().__init__(address, _FrameHandler)

    def _ensure_arena(self) -> ShmArena | None:
        """Create the arena on the first shm-negotiating hello — plain
        fleets never allocate /dev/shm capacity."""
        if self.arena_bytes <= 0:
            return None
        with self._arena_lock:
            if self.arena is None:
                self.arena = ShmArena(self.arena_bytes)
                for shard in self.shards.values():
                    shard.arena = self.arena
            return self.arena

    def _adopt_view(self, view: "dict | None") -> "dict | None":
        with self._view_lock:
            if view is not None and (
                self.fleet_view is None
                or int(view["epoch"]) > int(self.fleet_view["epoch"])
            ):
                self.fleet_view = dict(view)
            return None if self.fleet_view is None else dict(self.fleet_view)

    def _encode_for_reply(self, shard: _Server, key, coord, header: dict, codec=None):
        """(meta, buf) for one fetched block, honouring the request's
        negotiated data plane: shm reference > at-rest passthrough >
        wire codec > raw.  ``codec`` overrides the header's connection-
        level codec (per-key tags inside a fetch_many)."""
        if header.get("shm"):
            ref = shard.arena_ref(key, coord)
            if ref is not None:
                meta, off, nbytes = ref
                return dict(meta, shm=[off, nbytes]), b""
        if codec is None:
            codec = header.get("codec")
        block = shard.fetch_resident(key, coord)
        if isinstance(block, Encoded):
            if codec:  # codec-capable client: ship the resident blob as-is
                return dict(block.meta), memoryview(block.data)
            block = block.decode()
        return encode_block(block, codec)

    def dispatch(self, header: dict, payload: bytearray) -> tuple[dict, object]:
        op = header.get("op")
        if op == "ping":
            return {"ok": True, "sids": sorted(self.shards)}, b""
        if op == "hello":
            if self.compat:
                raise ValueError(f"unknown op {op!r}")
            resp: dict = {
                "ok": True,
                "sids": sorted(self.shards),
                "codecs": [c for c in WIRE_CODECS if c != "raw"],
                "pkc": True,  # per-key codec tags accepted in fetch_many reqs
            }
            if header.get("shm"):
                arena = self._ensure_arena()
                if arena is not None:
                    resp["shm"] = arena.describe()
            return resp, b""
        if op == "epoch":
            if self.compat:
                raise ValueError(f"unknown op {op!r}")
            return {"ok": True, "view": self._adopt_view(None)}, b""
        if op == "join":
            if self.compat:
                raise ValueError(f"unknown op {op!r}")
            return {"ok": True, "view": self._adopt_view(header.get("view"))}, b""
        if op == "leave":
            if self.compat:
                raise ValueError(f"unknown op {op!r}")
            view = self._adopt_view(header.get("view"))
            if header.get("purge"):
                departed = self.shards.get(header.get("member"))
                if departed is not None:
                    departed.clear()
            return {"ok": True, "view": view}, b""
        sid = header.get("sid")
        if sid not in self.shards:
            raise ValueError(f"shard {sid} not hosted here (have {sorted(self.shards)})")
        shard = self.shards[sid]
        if op == "gen":
            if self.compat:
                raise ValueError(f"unknown op {op!r}")
            return {
                "ok": True,
                "gens": shard.gen(header.get("bump"), header.get("want")),
            }, b""
        if op == "store":
            meta = header["array"]
            key = _key_from_json(header["key"])
            coord = tuple(header["coord"])
            box = _bb_from_json(header["bb"])
            if self.at_rest and is_lossless(meta) and meta.get("codec"):
                # keep the losslessly-compressed blob resident: decode is
                # deferred to fetch time (plain clients) or skipped
                # entirely (codec clients get the blob passed through)
                shard.store(key, coord, box, Encoded(meta, bytes(payload)))
            else:
                shard.store(
                    key,
                    coord,
                    box,
                    decode_block(meta, payload),
                    owned=True,  # the frame buffer is private: no second copy
                )
            return {"ok": True}, b""
        if op == "fetch":
            meta, buf = self._encode_for_reply(
                shard, _key_from_json(header["key"]), tuple(header["coord"]), header
            )
            return {"ok": True, "array": meta}, buf
        if op == "fetch_many":
            # scatter-IO: per-block buffers with explicit offsets in the
            # header; the send path hands the list straight to sendmsg —
            # payloads are never concatenated server-side
            metas, bufs = [], []
            off = 0
            for req in header["reqs"]:
                kj, coord = req[0], req[1]
                meta, buf = self._encode_for_reply(
                    shard,
                    _key_from_json(kj),
                    tuple(coord),
                    header,
                    codec=req[2] if len(req) > 2 else None,
                )
                n = _nbytes(buf)
                if "shm" not in meta:
                    meta = dict(meta, off=off, len=n)
                    off += n
                    bufs.append(buf)
                metas.append(meta)
            return {"ok": True, "arrays": metas}, bufs
        if op == "put_meta":
            shard.put_meta(
                _key_from_json(header["key"]),
                tuple(header["coord"]),
                _bb_from_json(header["bb"]),
                _homes_json(header["home"]),
            )
            return {"ok": True}, b""
        if op == "put_meta_batch":
            existing: dict = {}
            had = []
            for kj, coord, bbj, home in header["entries"]:
                key = _key_from_json(kj)
                if key not in existing:
                    existing[key] = shard.lookup(key)
                if tuple(coord) in existing[key]:
                    had.append(list(coord))
                shard.put_meta(key, tuple(coord), _bb_from_json(bbj), _homes_json(home))
            return {"ok": True, "had": had}, b""
        if op == "lookup":
            blocks = shard.lookup(_key_from_json(header["key"]))
            return {
                "ok": True,
                "blocks": [
                    [list(coord), _bb_to_json(bb), home]
                    for coord, (bb, home) in blocks.items()
                ],
            }, b""
        if op == "keys":
            return {"ok": True, "keys": [_key_to_json(k) for k in shard.keys()]}, b""
        if op == "drop":
            shard.drop(_key_from_json(header["key"]))
            return {"ok": True}, b""
        if op == "drop_block":
            shard.drop_block(_key_from_json(header["key"]), tuple(header["coord"]))
            return {"ok": True}, b""
        if op == "payload_bytes":
            return {"ok": True, "nbytes": shard.payload_bytes}, b""
        raise ValueError(f"unknown op {op!r}")


class _FrameHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        sock: socket.socket = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                header, payload, _ = recv_frame(sock)
            except (TransportError, ConnectionError, OSError):
                return  # client went away
            try:
                rheader, rpayload = self.server.dispatch(header, payload)
            except Exception as e:  # noqa: BLE001 — every error crosses the wire
                rheader, rpayload = (
                    {"ok": False, "etype": type(e).__name__, "msg": str(e)},
                    b"",
                )
            try:
                if isinstance(rpayload, list):
                    send_frame_parts(sock, rheader, rpayload)
                else:
                    send_frame(sock, rheader, rpayload)
            except OSError:
                return


def serve(
    host: str = "127.0.0.1",
    port: int = 0,
    sids: Iterable[int] = (0,),
    *,
    arena_bytes: int = DEFAULT_ARENA_BYTES,
    at_rest: bool = False,
) -> None:
    """Run a shard host in the foreground (the ``python -m`` entry).

    Prints ``REPRO_NET LISTENING <port>`` once bound so a parent process
    (or an operator's script) can discover the ephemeral port.
    """
    import signal

    server = _NetServer((host, port), sids, arena_bytes=arena_bytes, at_rest=at_rest)

    def _sigterm(_sig, _frm):
        # ServerProcess.stop() sends SIGTERM; without a handler the
        # finally below never runs and the shm arena is left for the
        # parent's resource tracker to reclaim (noisily)
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (embedded use)
    print(f"REPRO_NET LISTENING {server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.arena is not None:
            server.arena.close(unlink=True)


# ---------------------------------------------------------------------------
# process management
# ---------------------------------------------------------------------------
def _src_root() -> str:
    # net.py lives at <src>/repro_torch/storage/net.py
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ServerProcess:
    """Handle on one shard-host subprocess (``python -m repro_torch.storage.net``)."""

    def __init__(
        self,
        sids: Iterable[int] = (0,),
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        startup_timeout: float = 60.0,
        arena_bytes: int = DEFAULT_ARENA_BYTES,
        at_rest: bool = False,
        extra_env: dict[str, str] | None = None,
    ) -> None:
        self.sids = [int(s) for s in sids]
        self.host = host
        self.port = int(port)
        self.startup_timeout = startup_timeout
        self.arena_bytes = int(arena_bytes)
        self.at_rest = bool(at_rest)
        self.extra_env = dict(extra_env) if extra_env else {}
        self.proc: subprocess.Popen | None = None

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> "ServerProcess":
        if self.proc is not None:
            raise RuntimeError("ServerProcess already started")
        env = os.environ.copy()
        env.update(self.extra_env)
        env["PYTHONPATH"] = _src_root() + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        cmd = [
            sys.executable,
            "-u",
            "-m",
            "repro_torch.storage.net",
            "--host",
            self.host,
            "--port",
            str(self.port),
            "--sids",
            ",".join(map(str, self.sids)),
            "--arena-bytes",
            str(self.arena_bytes),
        ]
        if self.at_rest:
            cmd.append("--at-rest")
        self.proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        # a reader thread feeds a queue so the deadline holds even when
        # the child stays alive but silent (readline would block forever);
        # after startup the same thread keeps the pipe drained
        lines: "queue.Queue[str | None]" = queue.Queue()
        threading.Thread(
            target=self._drain, args=(self.proc.stdout, lines), daemon=True
        ).start()
        deadline = time.monotonic() + self.startup_timeout
        banner: list[str] = []
        while True:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                self.stop()
                raise TransportError(
                    f"DMS server startup timed out after {self.startup_timeout}s: "
                    + "".join(banner[-20:])
                ) from None
            if line is None:
                code = self.proc.poll()
                self.proc = None  # failed boot: the handle must stay retryable
                raise TransportError(
                    f"DMS server failed to start (exit={code}): "
                    + "".join(banner[-20:])
                )
            if line.startswith("REPRO_NET LISTENING"):
                self.port = int(line.split()[2])
                break
            banner.append(line)
        return self

    @staticmethod
    def _drain(stream, lines: "queue.Queue") -> None:
        try:
            for line in stream:
                lines.put(line)
        except (ValueError, OSError):
            pass
        finally:
            lines.put(None)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, timeout: float = 5.0) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        # reset the handle so start() works again — a stopped/crashed
        # server must be restartable on its (now known) port, which is
        # the crash-simulation primitive the failover tests build on
        self.proc = None

    def kill(self) -> None:
        """Hard-kill (crash simulation for failover/restart tests)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc = None

    def __enter__(self) -> "ServerProcess":
        return self.start() if self.proc is None else self

    def __exit__(self, *exc) -> None:
        self.stop()


class ServerGroup:
    """A started fleet of shard hosts + the endpoint table for clients."""

    def __init__(self, procs: list[ServerProcess], endpoints: list[tuple[str, int]]):
        self.procs = procs
        self.endpoints = endpoints

    @property
    def num_servers(self) -> int:
        return len(self.endpoints)

    def transport(self, **kw) -> SocketTransport:
        return SocketTransport(self.endpoints, **kw)

    def add_server(self, *, sid: int | None = None, **kw) -> tuple[int, tuple[str, int]]:
        """Start one more shard host (for elastic-join tests/deploys):
        boots a fresh :class:`ServerProcess` for ``sid`` (default: next
        free id), appends it to the group, and returns ``(sid,
        address)`` — feed both to ``DistributedMemoryStorage.
        add_server`` to bring it into the ring."""
        sid = (max((s for p in self.procs for s in p.sids), default=-1) + 1
               if sid is None else int(sid))
        if sid > len(self.endpoints):
            # sids are endpoint-table indices: a skipped-ahead id would
            # leave placeholder rows that crash transport construction
            raise ValueError(
                f"sid {sid} skips ahead of the endpoint table "
                f"(next free id is {len(self.endpoints)})"
            )
        sp = ServerProcess([sid], **kw).start()
        self.procs.append(sp)
        if sid < len(self.endpoints):
            self.endpoints[sid] = sp.address
        else:
            self.endpoints.append(sp.address)
        return sid, sp.address

    def proc_for(self, sid: int) -> ServerProcess | None:
        for p in self.procs:
            if int(sid) in p.sids:
                return p
        return None

    def close(self) -> None:
        for p in self.procs:
            p.stop()

    def __enter__(self) -> "ServerGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn_servers(
    num_servers: int,
    *,
    processes: int | None = None,
    host: str = "127.0.0.1",
    startup_timeout: float = 60.0,
    arena_bytes: int = DEFAULT_ARENA_BYTES,
    at_rest: bool = False,
    extra_env: dict[str, str] | None = None,
) -> ServerGroup:
    """Start ``num_servers`` shards spread over ``processes`` hosts.

    Defaults to one process per shard (the fully distributed shape);
    ``processes=M`` packs shards contiguously onto M processes, matching
    a deployment where each node runs one server daemon with several
    shards.  Each process gets an ``arena_bytes`` shared-memory budget
    (allocated lazily on the first shm-negotiating client; 0 disables);
    ``at_rest=True`` keeps losslessly-compressed puts resident in
    compressed form.
    """
    num_servers = int(num_servers)
    if num_servers < 1:
        raise ValueError("need at least one server")
    processes = num_servers if processes is None else max(1, min(processes, num_servers))
    per = -(-num_servers // processes)  # ceil
    procs: list[ServerProcess] = []
    endpoints: list[tuple[str, int] | None] = [None] * num_servers
    try:
        for p in range(processes):
            sids = list(range(p * per, min((p + 1) * per, num_servers)))
            if not sids:
                break
            sp = ServerProcess(
                sids,
                host=host,
                startup_timeout=startup_timeout,
                arena_bytes=arena_bytes,
                at_rest=at_rest,
                extra_env=extra_env,
            ).start()
            procs.append(sp)
            for sid in sids:
                endpoints[sid] = sp.address
    except Exception:
        for sp in procs:
            sp.stop()
        raise
    return ServerGroup(procs, endpoints)


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.storage.net",
        description="Host DMS storage shards behind a TCP socket loop.",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = pick an ephemeral port")
    ap.add_argument(
        "--sids", default="0", help="comma-separated global shard ids hosted here"
    )
    ap.add_argument(
        "--arena-bytes",
        type=int,
        default=DEFAULT_ARENA_BYTES,
        help="shared-memory arena budget for same-host zero-copy fetches "
        "(allocated lazily on first use; 0 disables)",
    )
    ap.add_argument(
        "--at-rest",
        action="store_true",
        help="keep losslessly-compressed puts resident in compressed form",
    )
    args = ap.parse_args(argv)
    sids = [int(s) for s in args.sids.split(",") if s.strip() != ""]
    serve(args.host, args.port, sids, arena_bytes=args.arena_bytes, at_rest=args.at_rest)


if __name__ == "__main__":
    main()

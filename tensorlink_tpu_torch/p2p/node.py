"""P2PNode — authenticated asyncio TCP mesh node.

Capability match for the reference's ``Smartnode`` (p2p/smart_node.py):
listener + handshake, bootstrap to seed validators (smart_node.py:1100-1159),
DHT query routing with timeout + reroute (533-577), per-IP rate limiting
(247-250), tagged logging. Redesigned:

- asyncio event loop in a dedicated thread (reference: thread per socket);
  synchronous callers use :meth:`call`.
- Handshake is a 4-step mutual RSA challenge (HELLO→CHALLENGE→PROOF→WELCOME)
  over the single listener socket — no random-number OAEP dance and no "port
  swap" reconnection (reference smart_node.py:786-955).
- Request/response correlation by explicit ``_rid`` ids instead of polling
  shared dicts.

No torch or jax imports here — the networking process stays device-free.
"""

from __future__ import annotations

import asyncio
import secrets
import threading
import time
from pathlib import Path
from typing import Any, Awaitable, Callable

from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.crypto import identity as crypto
from tensorlink_tpu_torch.p2p import protocol as proto
from tensorlink_tpu_torch.p2p.connection import Connection
from tensorlink_tpu_torch.p2p.dht import DHT, hash_key
from tensorlink_tpu_torch.p2p.monitor import RateLimiter
from tensorlink_tpu_torch.p2p.reputation import ReputationTracker

Handler = Callable[[Connection, int, str, Any], Awaitable[None]]

# Record prefixes that replicate across validators: job records (repair
# depends on job:{id} surviving the storing validator) and proposal bodies
# (vote lookups). Everything else stays local-first.
REPLICATED_PREFIXES = ("job:", "proposal:")

# total bound on the handshake's on-chain credential check — the RPC
# client's socket timeouts are per-op, so a slow-drip registry endpoint
# needs an overall ceiling (fails CLOSED on expiry)
CREDENTIAL_CHECK_TIMEOUT = 15.0
# cap on concurrently-outstanding credential-check threads (abandoned
# slow-drip checks keep their thread alive past the timeout); at the cap
# further handshakes fail closed immediately
CREDENTIAL_CHECK_MAX_LIVE = 32


class HandshakeError(Exception):
    pass


class P2PNode:
    def __init__(
        self,
        role: str,
        *,
        host: str = "0.0.0.0",
        port: int = 0,
        key_dir: str | Path = "keys",
        local_test: bool = False,
        spill_dir: str | Path | None = None,
        max_connections: int = 256,
        request_timeout: float = 10.0,
        identity_name: str | None = None,
    ):
        self.role = role
        self.local_test = local_test
        self.host = "127.0.0.1" if local_test else host
        self.port = port
        # identity_name separates keypairs for same-role nodes sharing a
        # key_dir (reference duplicate="1" role suffix, tests/conftest.py:114)
        # while the advertised role stays canonical for peer-role routing.
        self.identity = crypto.load_or_create_identity(identity_name or role, key_dir)
        self.node_id = crypto.node_id_from_public_key(self.identity.public_pem)
        self.spill_dir = spill_dir
        self.max_connections = max_connections
        self.request_timeout = request_timeout
        self.log = get_logger(f"p2p.{role}.{self.node_id[:8]}")

        self.connections: dict[str, Connection] = {}  # node_id -> conn
        self.roles: dict[str, str] = {}  # node_id -> role
        self.addresses: dict[str, tuple[str, int]] = {}  # node_id -> (host, port)
        self.dht = DHT(self.node_id, forward=self._dht_forward)
        self.limiter = RateLimiter()
        self.reputation = ReputationTracker()
        # optional Sybil gate (reference smart_node.py:708-739 checks a
        # peer's chain-registered identity before accepting its role):
        # (node_id, role) -> bool, called off-loop (it may do blocking RPC).
        # None = local reputation only.
        self.credential_check: Callable[[str, str], bool] | None = None
        # count of credential-check threads abandoned mid-RPC (slow-drip
        # registry endpoints) — each holds one daemon thread + socket until
        # the RPC's 1 MB read cap runs out; exposed for observability
        self._cred_abandoned = 0  #: guarded by the node event loop
        # outstanding credential-check threads; bounded so hostile traffic
        # from many IPs cannot accumulate dripping threads without limit —
        # incremented on the loop, decremented from the check threads
        self._cred_live = 0  #: guarded by self._cred_lock
        self._cred_lock = threading.Lock()
        self.handlers: dict[str, Handler] = {}
        self.started = threading.Event()
        self.terminate = threading.Event()

        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._pending: dict[str, asyncio.Future] = {}
        self._pending_conn: dict[str, Connection] = {}  # rid -> conn it rides
        self._conn_tasks: set[asyncio.Task] = set()

        self.register(proto.DHT_GET, self._handle_dht_get)
        self.register(proto.DHT_STORE, self._handle_dht_store)
        self.register(proto.DHT_DELETE, self._handle_dht_delete)
        self.register(proto.DHT_SYNC, self._handle_dht_sync)
        self.register(proto.PEERS, self._handle_peers)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Run the event loop + listener in a dedicated thread."""
        if self._thread:
            return
        ready = threading.Event()

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._start_server())
            ready.set()
            self.started.set()
            try:
                self._loop.run_forever()
            finally:
                self._loop.run_until_complete(self._shutdown())
                self._loop.close()

        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=run, name=f"p2p-{self.role}", daemon=True)
        self._thread.start()
        if not ready.wait(10):
            raise RuntimeError("p2p node failed to start")
        self.log.info("listening on %s:%s id=%s", self.host, self.port, self.node_id[:16])

    def stop(self) -> None:
        if not self._loop:
            return
        self.terminate.set()
        if not self._loop.is_closed():  # idempotent: double-stop is a no-op
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None

    async def _start_server(self) -> None:
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port or None
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def _shutdown(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for conn in list(self.connections.values()):
            await conn.close()
        for t in list(self._conn_tasks):
            t.cancel()

    def call(self, coro, timeout: float | None = 30.0):
        """Run a coroutine on the node loop from another thread."""
        assert self._loop is not None, "node not started"
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    # ------------------------------------------------------------------
    # handshake
    # ------------------------------------------------------------------
    async def _read_frame(self, reader: asyncio.StreamReader) -> tuple[int, str, bytes]:
        head = await reader.readexactly(proto.HEADER_SIZE)
        hdr = proto.unpack_header(head)
        if hdr.payload_len > 1 << 20:
            raise HandshakeError("oversized handshake frame")
        tag = (await reader.readexactly(hdr.tag_len)).decode("ascii")
        payload = await reader.readexactly(hdr.payload_len)
        return hdr.kind, tag, payload

    @staticmethod
    async def _write_frame(writer: asyncio.StreamWriter, tag: str, body: dict) -> None:
        kind, tag, payload = proto.control(tag, body)
        writer.write(proto.pack_header(kind, tag, len(payload)) + payload)
        await writer.drain()

    def _hello_body(self, nonce: str) -> dict:
        return {
            "pub": self.identity.public_pem.decode(),
            "role": self.role,
            "nonce": nonce,
            "port": self.port,
            "id": self.node_id,
        }

    async def _check_credentials(self, node_id: str, role: str) -> None:
        """On-chain (or otherwise external) identity gate: a fresh Sybil key
        starts clean with every validator's LOCAL reputation, so role
        acceptance must also consult the shared registry (reference
        smart_node.py:708-739). Runs in a worker thread — the check is
        typically a blocking RPC — and BEFORE the handshake completes, so
        the refused peer sees a failed handshake on its own side."""
        if self.credential_check is None:
            return
        # one DEDICATED daemon thread per check — not the loop's default
        # executor (abandoned threads there starve the bridge pumps
        # node-wide) and not a small fixed pool (a slow-drip registry
        # endpoint resets the per-socket-op timeout every byte, so a
        # handful of dripping checks would wedge the pool and deny
        # authentication forever). Outstanding threads are CAPPED: at the
        # cap new handshakes fail closed immediately (a wedge now needs
        # that many concurrently dripping checks, with loud warnings the
        # whole way), and each abandoned thread's lifetime is bounded by
        # the RPC's 1 MB response cap.
        with self._cred_lock:
            if self._cred_live >= CREDENTIAL_CHECK_MAX_LIVE:
                self.log.warning(
                    "credential-check concurrency cap (%d) reached — "
                    "refusing handshake with %s (fail closed); registry "
                    "endpoint is likely hostile or down",
                    CREDENTIAL_CHECK_MAX_LIVE, node_id[:12],
                )
                raise HandshakeError(
                    f"credential check for {node_id[:12]} refused: "
                    "checker saturated"
                )
            self._cred_live += 1
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def deliver(cb) -> None:
            try:
                loop.call_soon_threadsafe(cb)
            # tlint: disable=TL005(loop already closed while the node stops — the result is moot)
            except RuntimeError:
                pass  # loop already closed (node stopping) — result moot

        def run_check() -> None:
            try:
                ok = self.credential_check(node_id, role)
            except BaseException as e:  # noqa: BLE001 — deliver, don't die
                deliver(
                    lambda: fut.set_exception(e) if not fut.done() else None
                )
                return
            finally:
                with self._cred_lock:
                    self._cred_live -= 1
            deliver(lambda: fut.set_result(ok) if not fut.done() else None)

        threading.Thread(
            target=run_check, name="cred-check", daemon=True
        ).start()
        try:
            # total bound, not just the RPC's per-socket-op timeout. On
            # expiry the thread is abandoned to finish; the handshake
            # fails CLOSED now.
            ok = await asyncio.wait_for(fut, timeout=CREDENTIAL_CHECK_TIMEOUT)
        except asyncio.TimeoutError:
            self._cred_abandoned += 1
            self.log.warning(
                "credential check for %s exceeded %.0fs — thread abandoned "
                "(%d total); registry endpoint may be hostile or down",
                node_id[:12], CREDENTIAL_CHECK_TIMEOUT, self._cred_abandoned,
            )
            raise HandshakeError(
                f"credential check for {node_id[:12]} timed out"
            ) from None
        except Exception as e:
            raise HandshakeError(
                f"credential check for {node_id[:12]} errored: {e}"
            ) from None
        if not ok:
            raise HandshakeError(
                f"peer {node_id[:12]} role={role} not registered "
                "with the credential registry"
            )

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        ip = (writer.get_extra_info("peername") or ("?",))[0]
        if not self.limiter.allow(ip):
            self.log.warning("rate-limited %s", ip)
            writer.close()
            return
        if len(self.connections) >= self.max_connections:
            writer.close()
            return
        try:
            kind, tag, payload = await asyncio.wait_for(self._read_frame(reader), 10)
            if tag != proto.HELLO:
                raise HandshakeError(f"expected hello, got {tag}")
            hello = proto.parse_control(payload)
            peer_pub = hello["pub"].encode()
            if not crypto.authenticate_public_key(peer_pub):
                raise HandshakeError("bad public key")
            peer_id = crypto.node_id_from_public_key(peer_pub)
            if not self.reputation.allowed(peer_id):
                # reject before any further protocol steps so the initiator
                # sees a failed handshake, not a connection that dies later
                raise HandshakeError(
                    f"peer {peer_id[:12]} reputation below threshold "
                    f"({self.reputation.score(peer_id):.1f})"
                )
            nonce_b = secrets.token_hex(32)
            await self._write_frame(
                writer,
                proto.CHALLENGE,
                {
                    **self._hello_body(nonce_b),
                    "sig": crypto.sign(self.identity, hello["nonce"].encode()).hex(),
                },
            )
            kind, tag, payload = await asyncio.wait_for(self._read_frame(reader), 10)
            if tag != proto.PROOF:
                raise HandshakeError(f"expected proof, got {tag}")
            proof = proto.parse_control(payload)
            if not crypto.verify(peer_pub, bytes.fromhex(proof["sig"]), nonce_b.encode()):
                raise HandshakeError("bad proof signature")
            # registry gate AFTER the proof: the peer has demonstrated key
            # possession, so an attacker cannot turn unauthenticated HELLOs
            # into blocking chain RPCs (the refused peer still sees a failed
            # handshake — no WELCOME was sent)
            await self._check_credentials(peer_id, hello.get("role", ""))
            await self._write_frame(writer, proto.WELCOME, {"id": self.node_id})
            await self._register_peer(
                reader, writer, peer_pub, hello["role"], ip, int(hello.get("port", 0))
            )
        except (HandshakeError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, OSError, KeyError, ValueError) as e:
            self.log.warning("handshake with %s failed: %s", ip, e)
            writer.close()

    async def connect(self, host: str, port: int) -> Connection:
        """Outgoing connection + handshake; returns the live Connection."""
        for conn in self.connections.values():
            if self.addresses.get(conn.node_id) == (host, port):
                return conn
        reader, writer = await asyncio.open_connection(host, port)
        try:
            nonce_a = secrets.token_hex(32)
            await self._write_frame(writer, proto.HELLO, self._hello_body(nonce_a))
            kind, tag, payload = await asyncio.wait_for(self._read_frame(reader), 10)
            if tag != proto.CHALLENGE:
                raise HandshakeError(f"expected challenge, got {tag}")
            ch = proto.parse_control(payload)
            peer_pub = ch["pub"].encode()
            if not crypto.authenticate_public_key(peer_pub):
                raise HandshakeError("bad public key")
            if not crypto.verify(peer_pub, bytes.fromhex(ch["sig"]), nonce_a.encode()):
                raise HandshakeError("bad challenge signature")
            await self._check_credentials(
                crypto.node_id_from_public_key(peer_pub), ch.get("role", "")
            )
            await self._write_frame(
                writer,
                proto.PROOF,
                {"sig": crypto.sign(self.identity, ch["nonce"].encode()).hex()},
            )
            kind, tag, payload = await asyncio.wait_for(self._read_frame(reader), 10)
            if tag != proto.WELCOME:
                raise HandshakeError(f"expected welcome, got {tag}")
            return await self._register_peer(
                reader, writer, peer_pub, ch["role"], host, int(ch.get("port", port))
            )
        except Exception:
            writer.close()
            raise

    async def _register_peer(
        self,
        reader,
        writer,
        peer_pub: bytes,
        peer_role: str,
        host: str,
        listen_port: int,
    ) -> Connection:
        node_id = crypto.node_id_from_public_key(peer_pub)
        if node_id == self.node_id:
            raise HandshakeError("connected to self")
        if not self.reputation.allowed(node_id):
            # reputation gate at handshake (reference smart_node.py:681-698):
            # the peer proved its key, and that key's history disqualifies it
            raise HandshakeError(
                f"peer {node_id[:12]} reputation below threshold "
                f"({self.reputation.score(node_id):.1f})"
            )
        if self.reputation.score(node_id) < 0:
            # clean handshakes only help a tarnished peer crawl back toward
            # neutral — a reconnect loop must not FARM positive credit to
            # absorb later misbehavior (goodwill comes from completed jobs)
            self.reputation.record(node_id, "handshake_ok")
        old = self.connections.get(node_id)
        if old is not None:
            await old.close()
        conn = Connection(reader, writer, spill_dir=self.spill_dir)
        conn.node_id = node_id
        conn.role = peer_role
        conn.pub_pem = peer_pub
        self.connections[node_id] = conn
        self.roles[node_id] = peer_role
        if listen_port:
            self.addresses[node_id] = (host, listen_port)
        self.dht.add_node(node_id)
        task = asyncio.ensure_future(conn.run(self._on_frame))
        self._conn_tasks.add(task)
        task.add_done_callback(lambda t: (self._conn_tasks.discard(t), self._on_disconnect(conn)))
        self.log.info("peer up %s role=%s %s:%s", node_id[:8], peer_role, host, listen_port)
        if self.role == "validator" and peer_role == "validator":
            # validators anti-entropy-sync replicated records on connect so a
            # late-joining validator serves jobs stored before it existed
            t = asyncio.ensure_future(self.sync_dht(conn))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)
        return conn

    def _on_disconnect(self, conn: Connection) -> None:
        if conn.node_id and self.connections.get(conn.node_id) is conn:
            del self.connections[conn.node_id]
            self.log.info("peer down %s", conn.node_id[:8])
        # fail in-flight requests riding this connection immediately —
        # otherwise callers wait out the full request timeout on a peer
        # that is already gone (and repair paths never learn the cause)
        for rid, c in list(self._pending_conn.items()):
            if c is conn:
                fut = self._pending.pop(rid, None)
                self._pending_conn.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_exception(
                        ConnectionError(
                            f"no connection to {conn.node_id[:12] if conn.node_id else '?'}"
                            " (peer dropped mid-request)"
                        )
                    )

    # ------------------------------------------------------------------
    # dispatch + request/response
    # ------------------------------------------------------------------
    def register(self, tag: str, handler: Handler) -> None:
        self.handlers[tag] = handler

    async def _on_frame(self, conn: Connection, kind: int, tag: str, payload) -> None:
        body = proto.parse_control(payload) if kind == proto.CONTROL else payload
        if isinstance(body, dict) and body.get("_resp"):
            fut = self._pending.pop(body.get("_rid"), None)
            if fut is not None and not fut.done():
                fut.set_result(body)
            # a reply whose requester timed out must never re-enter the
            # request handlers (a late PEERS reply would otherwise ping-pong)
            return
        handler = self.handlers.get(tag)
        if handler is None:
            conn.ghosts += 1
            self.reputation.record(conn.node_id or "", "ghost")
            self.log.debug("ghost frame tag=%s from %s", tag, conn.node_id and conn.node_id[:8])
            return
        try:
            await handler(conn, kind, tag, body)
        except Exception:
            self.log.exception("handler %s failed", tag)

    async def request(
        self, conn: Connection, tag: str, body: dict, timeout: float | None = None
    ) -> dict:
        """Send a control message and await the correlated reply."""
        rid = secrets.token_hex(8)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        self._pending_conn[rid] = conn
        try:
            await conn.send_control(tag, {**body, "_rid": rid})
            return await asyncio.wait_for(fut, timeout or self.request_timeout)
        finally:
            self._pending.pop(rid, None)
            self._pending_conn.pop(rid, None)

    @staticmethod
    async def respond(conn: Connection, tag: str, request_body: dict, body: dict) -> None:
        await conn.send_control(
            tag, {**body, "_rid": request_body.get("_rid"), "_resp": True}
        )

    # ------------------------------------------------------------------
    # DHT wiring
    # ------------------------------------------------------------------
    async def _dht_forward(self, peer_id: str, key: str, hops: int = 0) -> Any:
        conn = self.connections.get(peer_id)
        if conn is None:
            raise ConnectionError(f"no connection to {peer_id[:8]}")
        reply = await self.request(conn, proto.DHT_GET, {"key": key, "hops": hops})
        if reply.get("value") is None:
            return None
        return reply.get("value"), reply.get("ts")

    async def _handle_dht_get(self, conn, kind, tag, body) -> None:
        key = body["key"]
        hops = int(body.get("hops", 0))
        value = self.dht.get_local(key)
        if value is None and hops < 2:
            pool = [c for c in self.validator_ids() if c != conn.node_id]
            if pool:
                value = await self.dht.query(key, route_pool=pool, hops=hops + 1)
        # origin ts rides the reply so the requester's cache keeps LWW
        # semantics (an untimestamped cache write would beat tombstones)
        await self.respond(
            conn, proto.DHT_GET_RESP, body,
            {"key": key, "value": value, "ts": self.dht.updated_at.get(key)},
        )

    async def _fanout_validators(
        self, tag: str, body: dict, exclude: str | None = None
    ) -> None:
        """Best-effort control-frame push to every connected validator."""
        for nid in self.validator_ids():
            if nid == exclude:
                continue
            peer = self.connections.get(nid)
            if peer is not None:
                try:
                    await peer.send_control(tag, body)
                # tlint: disable=TL005(best-effort fanout — a dead validator peer re-syncs via anti-entropy)
                except (ConnectionError, OSError):
                    pass

    async def _handle_dht_store(self, conn, kind, tag, body) -> None:
        key, ts = body["key"], body.get("ts")
        if ts is None:
            # replicated records are LWW-ordered by origin ts; an
            # untimestamped REMOTE store has no place in that order and
            # could otherwise clear tombstones or overwrite newer records
            # (store()'s "local write always wins" rule is for this node's
            # own writes, not a peer omitting ts). Reject for replicated
            # prefixes; plain keys keep the legacy behavior.
            if not key.startswith(REPLICATED_PREFIXES):
                self.dht.store(key, body["value"])
            return
        # timestamped stores apply last-writer-wins, and a validator relays
        # accepted replicated records to its other validator peers — the
        # origin only reaches validators IT is connected to, so single-homed
        # workers/users still get multi-validator replication. Equal/older
        # timestamps are rejected, which terminates the relay.
        accepted = self.dht.merge({key: {"value": body["value"], "ts": float(ts)}})
        if accepted and self.role == "validator" and key.startswith(REPLICATED_PREFIXES):
            await self._fanout_validators(proto.DHT_STORE, body, exclude=conn.node_id)

    async def _handle_dht_delete(self, conn, kind, tag, body) -> None:
        key, ts = body["key"], body.get("ts")
        changed = self.dht.delete(key, ts=float(ts) if ts is not None else None)
        # relay replicated deletes exactly like stores — the tombstone makes
        # re-application a no-op, which terminates the flood
        if (
            changed and ts is not None and self.role == "validator"
            and key.startswith(REPLICATED_PREFIXES)
        ):
            await self._fanout_validators(proto.DHT_DELETE, body, exclude=conn.node_id)

    async def _handle_dht_sync(self, conn, kind, tag, body) -> None:
        """Anti-entropy: peer sent its replicated-key digest; reply with the
        records it is missing or holds stale (last-writer-wins on ts)."""
        entries = self.dht.missing_for(
            body.get("digest", {}), REPLICATED_PREFIXES
        )
        await self.respond(conn, proto.DHT_SYNC_RESP, body, {"entries": entries})

    async def sync_dht(self, conn: Connection) -> list[str]:
        """Pull replicated records this node lacks from ``conn``'s peer.
        Runs from both ends of a validator-validator connection, so one pull
        each way yields a full bidirectional sync."""
        try:
            reply = await self.request(
                conn, proto.DHT_SYNC,
                {"digest": self.dht.digest(REPLICATED_PREFIXES)},
            )
        except (ConnectionError, OSError, asyncio.TimeoutError, TimeoutError):
            return []
        accepted = self.dht.merge(reply.get("entries", {}))
        if accepted:
            self.log.info(
                "dht sync from %s: %d records", conn.node_id[:8], len(accepted)
            )
        return accepted

    async def _handle_peers(self, conn, kind, tag, body) -> None:
        peers = [
            {"id": nid, "role": self.roles.get(nid), "addr": list(self.addresses.get(nid, ()))}
            for nid in self.connections
            if self.roles.get(nid) == "validator" and nid in self.addresses
        ]
        await self.respond(conn, proto.PEERS, body, {"peers": peers})

    def validator_ids(self) -> list[str]:
        return [nid for nid, r in self.roles.items() if r == "validator" and nid in self.connections]

    async def dht_query(self, key: str, timeout: float = 3.0) -> Any:
        return await self.dht.query(key, route_pool=self.validator_ids(), timeout=timeout)

    async def dht_store_global(self, key: str, value: Any) -> None:
        """Store locally and push to connected validators, stamped with the
        origin write time so replicas and later anti-entropy syncs resolve
        conflicts last-writer-wins (the reference's replication is a TODO,
        dht.py:135-137)."""
        self.dht.store(key, value)
        await self._fanout_validators(
            proto.DHT_STORE,
            {"key": key, "value": value, "ts": self.dht.updated_at[key]},
        )

    async def dht_delete_global(self, key: str) -> None:
        """Delete locally (tombstoned) and push the delete to connected
        validators so replicas drop their copies too — without this, a
        shutdown job's record would outlive the job on every replica and be
        resurrected by the next anti-entropy sync."""
        self.dht.delete(key)
        await self._fanout_validators(
            proto.DHT_DELETE, {"key": key, "ts": self.dht.tombstones.get(key)}
        )

    # ------------------------------------------------------------------
    # bootstrap
    # ------------------------------------------------------------------
    async def bootstrap(self, seeds: list[tuple[str, int]], retries: int = 3) -> int:
        """Connect to seed validators; learn + connect to their validator
        peers (reference smart_node.py:1100-1159, retry loop
        worker_thread.py:189-197). Returns number of live connections."""
        for attempt in range(retries):
            for host, port in seeds:
                if (host, port) == (self.host, self.port):
                    continue
                try:
                    conn = await self.connect(host, port)
                    reply = await self.request(conn, proto.PEERS, {})
                    for peer in reply.get("peers", []):
                        pid, addr = peer.get("id"), peer.get("addr")
                        if pid and addr and pid != self.node_id and pid not in self.connections:
                            try:
                                await self.connect(addr[0], addr[1])
                            # tlint: disable=TL005(bootstrap keeps trying other advertised peers; the outer seed loop logs)
                            except (OSError, HandshakeError, asyncio.TimeoutError):
                                pass
                except (OSError, HandshakeError, asyncio.TimeoutError, ConnectionError) as e:
                    self.log.warning("bootstrap %s:%s failed: %s", host, port, e)
            if self.connections or not seeds:
                break
            await asyncio.sleep(1.5 * (attempt + 1))
        return len(self.connections)

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def status(self) -> dict:
        return {
            "id": self.node_id,
            "role": self.role,
            "addr": [self.host, self.port],
            "peers": {
                nid[:16]: {
                    "role": self.roles.get(nid),
                    "latency_s": c.latency_s,
                    "sent": c.bytes_sent,
                    "recv": c.bytes_received,
                    "ghosts": c.ghosts,
                }
                for nid, c in self.connections.items()
            },
            "dht_keys": len(self.dht.store_map),
            "uptime_s": time.monotonic() - getattr(self, "_t0", time.monotonic()),
        }


__all__ = ["P2PNode", "HandshakeError", "hash_key"]

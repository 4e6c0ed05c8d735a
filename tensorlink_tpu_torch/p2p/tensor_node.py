"""TensorNode — array-aware protocol layer on top of :class:`P2PNode`.

Capability match for the reference's ``Torchnode`` (p2p/torch_node.py): the
wire verbs FORWARD/BACKWARD/GENERATE/MODULE/PARAMETERS/OPTIMIZER/TOKEN
(torch_node.py:119-131), tensor payloads, and module shipping. Redesigned:

- Tensor payloads are single TLTS frames (core/serialization.py) carrying an
  envelope ``{tag-meta, arrays}`` — the reference concatenates raw tensor
  bytes and JSON with fixed offsets (torch_node.py:825-836).
- Request/response correlation rides the same ``_rid`` scheme as control
  messages, so a FORWARD and its FORWARD_RESP pair up without per-module
  polling queues keyed ``(n_batch, n_micro, module_id)``
  (torch_node.py:664-718).
- Work that must reach the ML process is posted to ``self.work`` (an
  ``mp.Queue`` installed by the node runner) instead of being parked in
  shared memory for a 1 kHz poll loop (torch_node.py:838-851).

Still no torch here — arrays stay numpy until they cross into the ML process.
"""

from __future__ import annotations

import asyncio
from pathlib import Path

from tensorlink_tpu_torch.core import serialization as ser
from tensorlink_tpu_torch.p2p import protocol as proto
from tensorlink_tpu_torch.p2p.connection import Connection
from tensorlink_tpu_torch.p2p.node import P2PNode


class TensorNode(P2PNode):
    """P2PNode + tensor envelopes. Subclassed by the role servers."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.work = None  # mp.Queue installed by the runner (net -> ML)
        # roles without an ML token consumer (users — the synchronous driver
        # drains stream_buffers via next_tokens) set this False so the work
        # queue cannot grow unboundedly
        self.forward_tokens_to_ml = True
        self.stream_buffers: dict[str, asyncio.Queue] = {}  # stream_id -> tokens
        self.register(proto.TOKEN, self._handle_token)
        self.register(proto.STREAM_END, self._handle_token)

    # ------------------------------------------------------------------
    # envelopes
    # ------------------------------------------------------------------
    async def _on_frame(self, conn: Connection, kind: int, tag: str, payload) -> None:
        if kind == proto.BULK:
            if isinstance(payload, Path):
                body = ser.decode_from_file(payload)
                payload.unlink(missing_ok=True)
            else:
                body = ser.decode(payload, copy=True)
            if isinstance(body, dict) and body.get("_resp"):
                fut = self._pending.pop(body.get("_rid"), None)
                if fut is not None and not fut.done():
                    fut.set_result(body)
                return
            handler = self.handlers.get(tag)
            if handler is None:
                conn.ghosts += 1
                return
            try:
                await handler(conn, kind, tag, body)
            except Exception:
                self.log.exception("bulk handler %s failed", tag)
            return
        await super()._on_frame(conn, kind, tag, payload)

    async def send_tensor(self, conn: Connection, tag: str, body: dict) -> None:
        """Ship a dict that may contain numpy arrays as one bulk frame."""
        blob = ser.encode(body)
        await conn.send_frame(proto.BULK, tag, blob)

    async def tensor_request(
        self, conn: Connection, tag: str, body: dict, timeout: float | None = None
    ) -> dict:
        """Correlated array-carrying request; reply may be control or bulk.
        A peer that drops while the request is still being written fails
        it as one that drops while it waits for the reply does (the
        "no connection" ``ConnectionError`` of ``_on_disconnect``), so
        the caller's repair path sees a lost worker either way."""
        import secrets

        rid = secrets.token_hex(8)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        self._pending_conn[rid] = conn
        try:
            try:
                await self.send_tensor(conn, tag, {**body, "_rid": rid})
            except (ConnectionError, OSError) as e:
                nid = conn.node_id[:12] if conn.node_id else "?"
                raise ConnectionError(f"no connection to {nid} (peer "
                                      f"dropped mid-send: {e!r})") from e
            return await asyncio.wait_for(fut, timeout or self.request_timeout)
        finally:
            self._pending.pop(rid, None)
            self._pending_conn.pop(rid, None)

    async def tensor_respond(
        self, conn: Connection, tag: str, request_body: dict, body: dict
    ) -> None:
        await self.send_tensor(
            conn, tag, {**body, "_rid": request_body.get("_rid"), "_resp": True}
        )

    # ------------------------------------------------------------------
    # token streaming (reference torch_node.py:543-560,
    # validator_thread.py:211-265)
    # ------------------------------------------------------------------
    async def send_token(
        self, conn: Connection, stream_id: str, token_ids: list[int], done: bool = False
    ) -> None:
        tag = proto.STREAM_END if done else proto.TOKEN
        await conn.send_control(tag, {"stream": stream_id, "tokens": token_ids})

    async def _handle_token(self, conn, kind, tag, body) -> None:
        q = self.stream_buffers.setdefault(body["stream"], asyncio.Queue())
        await q.put((body.get("tokens", []), tag == proto.STREAM_END))
        if self.work is not None and self.forward_tokens_to_ml:
            self.post_work("token", {
                "stream": body["stream"],
                "tokens": body.get("tokens", []),
                "done": tag == proto.STREAM_END,
            })

    async def next_tokens(
        self, stream_id: str, timeout: float = 30.0
    ) -> tuple[list[int], bool]:
        """Await the next token batch for a stream; (tokens, done)."""
        q = self.stream_buffers.setdefault(stream_id, asyncio.Queue())
        return await asyncio.wait_for(q.get(), timeout)

    def drop_stream(self, stream_id: str) -> None:
        self.stream_buffers.pop(stream_id, None)

    # ------------------------------------------------------------------
    # ML-process handoff
    # ------------------------------------------------------------------
    def post_work(self, kind: str, item: dict) -> None:
        """Queue an event for the ML process (non-blocking, drops never)."""
        if self.work is not None:
            self.work.put((kind, item))


__all__ = ["TensorNode"]

"""TensorlinkAPI — the validator's HTTP endpoint.

Reference: api/node.py:94 (FastAPI + uvicorn in a daemon thread, routes
/v1/generate, /v1/chat/completions, /request-model, /model-status, /models,
/model-demand, /stats, /network-history, /node-info). Same routes and wire
shapes, implemented on stdlib asyncio (no fastapi/uvicorn in the serving image):
an HTTP/1.1 parser, JSON bodies, and SSE streaming fed by the compiled
decode loop through ``loop.call_soon_threadsafe`` (the reference feeds
asyncio queues from the ML thread the same way, api/node.py:440-454).
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable
from urllib.parse import unquote, urlparse

from tensorlink_tpu_torch.api.formatter import (
    SSE_DONE,
    ResponseFormatter,
    sse_event,
)
from tensorlink_tpu_torch.api.schemas import (
    ChatCompletionRequest,
    GenerationRequest,
    JobRequest,
    ValidationError,
)
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.core.metrics import MetricsRegistry, render_prometheus
from tensorlink_tpu_torch.core.trace import get_tracer, mint_trace_id

MAX_BODY = 8 << 20
MAX_CONCURRENT = 100  # reference api/node.py:537
REQUEST_TIMEOUT = 300.0  # reference api/node.py:506
STREAM_TOKEN_TIMEOUT = 30.0  # reference api/node.py:410


class HTTPError(Exception):
    def __init__(
        self,
        status: int,
        message: str,
        extra: dict | None = None,
        headers: dict | None = None,
    ):
        super().__init__(message)
        self.status = status
        self.body = {"error": message, **(extra or {})}
        self.headers = dict(headers or {})


# client-supplied X-Request-Id values must be safe to echo into a
# response header and to use as a tracer key: token charset only,
# bounded length — anything else (header-injection attempts, unbounded
# ids that could churn the tracer's LRU) gets a freshly minted id
_RID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# tlint: disable=TL006(read-only constant table — never mutated at runtime)
_STATUS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class TensorlinkAPI:
    """HTTP server bound to a validator node + its ML executor."""

    def __init__(
        self,
        node,  # ValidatorNode (runner)
        executor,  # DistributedValidator
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.node = node
        self.executor = executor
        self.host = host
        self.port = port
        self.log = get_logger("api")
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="api-ml")
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        # the transport-backstop gate: only ever touched on the server's
        # event loop (handler coroutines + the on-loop reject helper)
        self._inflight = 0  #: guarded by the event loop
        # per-connection request id (X-Request-Id / trace id): keyed by
        # writer so the response helpers can echo it on every reply path
        # (success, HTTPError, 500) without threading it through each
        # handler signature
        self._req_ids: dict = {}  #: guarded by the event loop
        # API-level metrics: the server's own registry, merged with every
        # hosted model's engine registry by the /metrics handler
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "tlink_http_requests_total", "HTTP requests handled"
        )
        self._m_errors = self.metrics.counter(
            "tlink_http_errors_total", "HTTP error responses sent"
        )
        self.metrics.gauge(
            "tlink_http_inflight", "generations in flight",
            fn=lambda: self._inflight,
        )

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "TensorlinkAPI":
        if self._thread:
            return self
        ready = threading.Event()

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def boot():
                self._server = await asyncio.start_server(
                    self._handle_conn, self.host, self.port or None
                )
                self.port = self._server.sockets[0].getsockname()[1]

            self._loop.run_until_complete(boot())
            ready.set()
            try:
                self._loop.run_forever()
            finally:
                self._loop.run_until_complete(self._shutdown())
                self._loop.close()

        self._thread = threading.Thread(target=run, name="api-http", daemon=True)
        self._thread.start()
        if not ready.wait(10):
            raise RuntimeError("API server failed to start")
        self.log.info("serving on http://%s:%s", self.host, self.port)
        return self

    async def _shutdown(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    def stop(self) -> None:
        if self._loop:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        self._pool.shutdown(wait=False)

    async def _ml(self, fn: Callable, *args) -> Any:
        """Run blocking executor work off the event loop."""
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args
        )

    # -- connection handling -------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            req = await asyncio.wait_for(self._read_request(reader), 30)
            if req is None:
                return
            method, path, headers, body = req
            # one trace id per request, echoed as X-Request-Id on every
            # response path below. A client-supplied id is honored (so a
            # gateway can pre-mint and correlate) only when it is a safe
            # header token — else a fresh id is minted
            client_rid = headers.get("x-request-id", "")
            rid = (
                client_rid if _RID_RE.match(client_rid)
                else mint_trace_id()
            )
            self._req_ids[writer] = rid
            self._m_requests.inc()
            await self._route(method, path, headers, body, writer)
        except HTTPError as e:
            self._m_errors.inc()
            rid = self._req_ids.get(writer)
            if rid and "trace_id" not in e.body:
                # rejection bodies (429s included) carry the trace id so a
                # client can hand /trace/<rid> to an operator verbatim
                e.body["trace_id"] = rid
            await self._send_json(writer, e.status, e.body, headers=e.headers)
        except asyncio.TimeoutError:
            self._m_errors.inc()
            await self._send_json(writer, 408, {"error": "request timeout"})
        # tlint: disable=TL005(client hung up mid-reply — no one left to answer)
        except (ConnectionError, OSError):
            pass
        except Exception:
            self._m_errors.inc()
            self.log.exception("request failed")
            try:
                await self._send_json(writer, 500, {"error": "internal error"})
            # tlint: disable=TL005(client hung up before the 500 could land — already logged above)
            except (ConnectionError, OSError):
                pass
        finally:
            self._req_ids.pop(writer, None)
            try:
                writer.close()
                await writer.wait_closed()
            # tlint: disable=TL005(closing an already-dead transport)
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _version = line.decode("latin1").split(None, 2)
        except ValueError:
            raise HTTPError(400, "malformed request line")
        headers: dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, v = h.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        if length > MAX_BODY:
            raise HTTPError(413, "body too large")
        body = await reader.readexactly(length) if length else b""
        return method.upper(), target, headers, body

    @staticmethod
    def _json_body(body: bytes) -> dict:
        if not body:
            return {}
        try:
            d = json.loads(body)
        except json.JSONDecodeError:
            raise HTTPError(400, "invalid JSON body")
        if not isinstance(d, dict):
            raise HTTPError(400, "JSON body must be an object")
        return d

    # tlint: on-loop — only called from the response coroutines
    def _rid_header(self, writer) -> str:
        rid = self._req_ids.get(writer)
        return f"X-Request-Id: {rid}\r\n" if rid else ""

    async def _send_json(
        self, writer, status: int, payload: dict,
        headers: dict | None = None,
    ) -> None:
        data = json.dumps(payload, default=str).encode()
        extra = "".join(
            f"{k}: {v}\r\n" for k, v in (headers or {}).items()
        )
        head = (
            f"HTTP/1.1 {status} {_STATUS.get(status, 'OK')}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{extra}"
            f"{self._rid_header(writer)}"
            "Connection: close\r\n\r\n"
        ).encode()
        writer.write(head + data)
        await writer.drain()

    async def _send_text(
        self, writer, status: int, text: str,
        content_type: str = "text/plain; version=0.0.4; charset=utf-8",
    ) -> None:
        """Plain-text response — the Prometheus exposition's shape."""
        data = text.encode()
        head = (
            f"HTTP/1.1 {status} {_STATUS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{self._rid_header(writer)}"
            "Connection: close\r\n\r\n"
        ).encode()
        writer.write(head + data)
        await writer.drain()

    async def _send_sse_headers(self, writer) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            + self._rid_header(writer).encode()
            + b"Connection: close\r\n\r\n"
        )
        await writer.drain()

    # -- routing --------------------------------------------------------
    async def _route(self, method, target, headers, body, writer) -> None:
        path = unquote(urlparse(target).path.rstrip("/") or "/")
        if method == "GET":
            if path == "/health":
                return await self._send_json(writer, 200, {"status": "ok"})
            if path == "/healthz":
                # the LB/router probe: dict reads only, never an
                # ML-process round trip (docs/SERVING.md "Telemetry")
                return await self._send_json(
                    writer, 200, self.executor.health_snapshot()
                )
            if path == "/metrics":
                # Prometheus text exposition: the API registry merged with
                # every hosted model's engine registry (or its last remote
                # serving snapshot as gauges). Rendered off the event loop
                # — collection takes the executor's host lock.
                text = await self._ml(self._metrics_text)
                return await self._send_text(writer, 200, text)
            if path.startswith("/trace/"):
                rid = path[len("/trace/"):]
                spans = get_tracer().collect(rid)
                if not spans and not get_tracer().known(rid):
                    raise HTTPError(404, f"no trace {rid}")
                return await self._send_json(
                    writer, 200, {"trace_id": rid, "spans": spans}
                )
            if path == "/models":
                return await self._send_json(writer, 200, self._models())
            if path == "/v1/models":
                # OpenAI-compatible listing so off-the-shelf clients
                # pointed at this endpoint can enumerate models
                return await self._send_json(writer, 200, {
                    "object": "list",
                    "data": [
                        {"id": j["name"], "object": "model",
                         "owned_by": "tensorlink"}
                        for j in self.executor.hosted_snapshot()
                        if j.get("status") == "ready"
                    ],
                })
            if path == "/model-demand":
                return await self._send_json(
                    writer, 200, {"demand": dict(self.executor.demand)}
                )
            if path.startswith("/model-status/"):
                name = path[len("/model-status/"):]
                return await self._send_json(
                    writer, 200, self.executor.model_status(name)
                )
            if path == "/stats":
                st = await self._ml(self.node.status)
                # per-hosted-model serving telemetry (scheduler counters
                # plus the slot engine's prefix-cache/occupancy snapshot
                # when continuous batching is active) rides the same
                # route operators already poll for node health
                st["models"] = await self._ml(self.executor.hosted_snapshot)
                return await self._send_json(writer, 200, st)
            if path == "/fleet":
                # per-model fleet state: router replica table + routed
                # counts, autopilot status/history (docs/SERVING.md
                # "Fleet serving"). Off the event loop — collection
                # takes the executor's host lock.
                return await self._send_json(
                    writer, 200,
                    {"fleet": await self._ml(self.executor.fleet_snapshot)},
                )
            if path == "/node-info":
                return await self._send_json(writer, 200, self._node_info())
            if path == "/network-history":
                return await self._send_json(
                    writer, 200, await self._ml(self._network_history)
                )
            if path == "/proposal-history":
                hist = await self._ml(
                    lambda: self.node.send_request("proposal_history")
                )
                return await self._send_json(writer, 200, {"proposals": hist})
            if path.startswith("/claim-info/"):
                wid = path[len("/claim-info/"):]
                claim = await self._ml(
                    lambda: self.node.send_request(
                        "claim_info", {"worker_id": wid}
                    )
                )
                return await self._send_json(
                    writer, 200 if "error" not in claim else 404, claim
                )
            raise HTTPError(404, f"no route {path}")
        if method != "POST":
            raise HTTPError(405, f"method {method} not allowed")
        data = self._json_body(body)
        if path == "/v1/generate":
            return await self._generate(data, writer)
        if path == "/v1/chat/completions":
            try:
                chat = ChatCompletionRequest.parse(data)
            except ValidationError as e:
                raise HTTPError(400, str(e))
            gen = chat.to_generation_request()
            return await self._generate_common(gen, writer, n=chat.n)
        if path == "/request-model":
            return await self._request_model(data, writer)
        if path == "/fleet/deploy":
            # operator trigger for a zero-dropped-token rolling deploy:
            # {"model": name, "replicas": ["r0", ...]} (replicas
            # optional = all). The autopilot drains each replica onto a
            # sibling, rebuilds it, rejoins it — streams migrate through
            # the export/stage/adopt path, bit-identical.
            model = str(data.get("model", ""))
            if not model:
                raise HTTPError(400, "deploy needs {'model': name}")
            reps = data.get("replicas")
            if reps is not None and not isinstance(reps, list):
                raise HTTPError(400, "'replicas' must be a list")
            out = await self._ml(
                lambda: self.executor.fleet_deploy(model, reps)
            )
            return await self._send_json(
                writer, 200 if out.get("ok") else 404, out
            )
        raise HTTPError(404, f"no route {path}")

    def _metrics_text(self) -> str:
        groups: list = [({}, self.metrics)]
        groups.extend(self.executor.metrics_groups())
        return render_prometheus(groups)

    # -- route bodies ---------------------------------------------------
    def _models(self) -> dict:
        # snapshot under the executor's lock — pool threads mutate hosted
        return {"models": self.executor.hosted_snapshot()}

    def _node_info(self) -> dict:
        return {
            "id": self.node.node_id,
            "role": self.node.role,
            "port": self.node.port,
            "hosted_models": [j["name"] for j in self.executor.hosted_snapshot()],
        }

    def _network_history(self) -> dict:
        # Keeper daily/weekly statistics (reference keeper.py:502-572)
        hist = self.node.send_request("network_history")
        st = self.node.status()
        roles: dict[str, int] = {}
        for p in st.get("peers", {}).values():
            roles[p.get("role", "?")] = roles.get(p.get("role", "?"), 0) + 1
        hist["current"] = {**hist.get("current", {}), **roles}
        return hist

    async def _request_model(self, data: dict, writer) -> None:
        try:
            jr = JobRequest.parse(data)
        except ValidationError as e:
            raise HTTPError(400, str(e))
        wait = bool(data.get("wait", True))
        if wait:
            job = await self._ml(
                lambda: self.executor.host_model(
                    jr.hf_name, batch=jr.batch, seq_len=jr.seq_len,
                    config=jr.config, quant=jr.quant,
                )
            )
            status = 200 if job.status == "ready" else 503
            out = {"model": jr.hf_name, "status": job.status}
            if job.error:
                out["error"] = job.error
            return await self._send_json(writer, status, out)
        self._pool.submit(
            self.executor.host_model, jr.hf_name,
            batch=jr.batch, seq_len=jr.seq_len, config=jr.config,
            quant=jr.quant,
        )
        await self._send_json(
            writer, 200, {"model": jr.hf_name, "status": "loading"}
        )

    async def _generate(self, data: dict, writer) -> None:
        try:
            gen = GenerationRequest.parse(data)
        except ValidationError as e:
            raise HTTPError(400, str(e))
        await self._generate_common(gen, writer)

    # tlint: on-loop — only called from _generate_common (a coroutine)
    def _reject_if_overloaded(self, job, gen, n: int) -> None:
        """Scheduler-driven backpressure (replaces the old flat
        concurrent-request counter): the hosted model's batcher judges the
        request's priority class against its queue caps and estimated
        wait, and a rejection becomes ``429`` with a ``Retry-After``
        header plus the class/queue-depth detail in the JSON body. The
        flat ``MAX_CONCURRENT`` bound survives only as the transport
        backstop protecting the HTTP pool itself (models without a
        class-aware batcher, requests racing a model reload)."""
        priority = getattr(gen, "priority", "") or None
        if self._inflight + n > MAX_CONCURRENT:
            raise HTTPError(
                429, "too many concurrent requests",
                {"queue_depth": self._inflight, "cap": MAX_CONCURRENT,
                 "priority": priority or "interactive", "retry_after": 1},
                headers={"Retry-After": "1"},
            )
        # a fleet-hosted model's gate is the ROUTER's: admit when any
        # non-draining replica would (docs/SERVING.md "Fleet serving")
        gate = getattr(job, "router", None)
        if gate is None:
            gate = getattr(job, "batcher", None)
        check = getattr(gate, "admission_check", None)
        rej = check(priority, n) if callable(check) else None
        if rej:
            retry = max(1, int(round(float(rej.get("retry_after", 1.0)))))
            raise HTTPError(
                429,
                f"{rej['priority']} queue is full "
                f"({rej['queue_depth']}/{rej['cap']} queued)",
                {"priority": rej["priority"],
                 "queue_depth": rej["queue_depth"],
                 "cap": rej["cap"], "retry_after": retry},
                headers={"Retry-After": str(retry)},
            )

    async def _generate_common(
        self, gen: GenerationRequest, writer, n: int = 1
    ) -> None:
        from tensorlink_tpu_torch.ml.validator import ModelNotReady

        rid = self._req_ids.get(writer, "")
        if getattr(self.executor, "recovering", False):
            # the validator is replaying its control journal (crash
            # recovery, docs/FAILURE_MODEL.md "Control plane") — a finite
            # window during which placements are still re-attaching.
            # Clients hold off and retry; /healthz shows the same flag so
            # LBs stop routing new placements here meanwhile.
            raise HTTPError(
                503, "validator is recovering — retry shortly",
                {"recovering": True, "retry_after": 2},
                headers={"Retry-After": "2"},
            )
        job = self.executor.hosted.get(gen.hf_name)
        if job is None or job.status != "ready":
            # 503 + auto-load trigger (reference api/node.py:143-155)
            if job is None:
                self._pool.submit(self.executor.host_model, gen.hf_name)
                state = "loading"
            else:
                state = job.status
            raise HTTPError(
                503, f"model {gen.hf_name} is {state}",
                {"model": gen.hf_name, "status": state},
            )
        self._reject_if_overloaded(job, gen, n)

        from tensorlink_tpu_torch.engine.scheduler import SchedulerOverloaded

        fmt = ResponseFormatter(gen.hf_name, gen.output_format)
        self._inflight += n
        try:
            if not gen.stream:
                # return_exceptions: every sibling dispatch completes before
                # an error propagates — otherwise one failed choice would
                # orphan n-1 running generations while _inflight is already
                # decremented for all n (silent 429-gate erosion; pinned by
                # test_api_unit.py::test_n_gt_1_failure_does_not_erode_gate)
                results = await asyncio.wait_for(
                    asyncio.gather(
                        *(self._ml(
                            lambda: self.executor.generate_api(
                                gen, trace_id=rid
                            )
                        ) for _ in range(n)),
                        return_exceptions=True,
                    ),
                    REQUEST_TIMEOUT,
                )
                for r in results:
                    if isinstance(r, ModelNotReady):
                        raise HTTPError(503, str(r))
                    if isinstance(r, SchedulerOverloaded):
                        # the engine-side backstop fired (a race admitted
                        # past the API gate): same 429 + Retry-After
                        # contract as the front gate
                        retry = max(1, int(round(r.retry_after)))
                        raise HTTPError(
                            429, str(r),
                            {"priority": r.priority,
                             "queue_depth": r.queue_depth,
                             "cap": r.cap, "retry_after": retry},
                            headers={"Retry-After": str(retry)},
                        )
                    if isinstance(r, ValidationError):
                        # request-vs-model mismatch detected past parse time
                        # (e.g. penalties on a multi-stage model)
                        raise HTTPError(400, str(r))
                    if isinstance(r, NotImplementedError):
                        # a path later slices of the port bring (the
                        # message names its ROADMAP item)
                        raise HTTPError(501, str(r))
                    if isinstance(r, BaseException):
                        raise r
                if n > 1:
                    # the n concurrent dispatches coalesced in the batcher;
                    # shape one chat.completion with n choices
                    return await self._send_json(
                        writer, 200, fmt.complete_multi(list(results))
                    )
                result = results[0]
                return await self._send_json(
                    writer, 200,
                    fmt.complete(
                        result["text"],
                        prompt_tokens=result["prompt_tokens"],
                        completion_tokens=result["completion_tokens"],
                        reasoning=result["reasoning"],
                        finish_reason=result["finish_reason"],
                        # only this path can carry the beam-clamp note:
                        # num_beams>1 + stream is rejected at parse time
                        # (schemas.py), and n>1 is a chat-completions-only
                        # field while num_beams is /v1/generate-only.
                        # jrid is the journal re-attach handle
                        # (docs/FAILURE_MODEL.md "Control plane")
                        extra={
                            k: result[k] for k in ("num_beams_used", "jrid")
                            if k in result
                        } or None,
                    ),
                )
            await self._stream_generate(gen, fmt, writer, rid)
        finally:
            self._inflight -= n

    async def _stream_generate(self, gen, fmt, writer, rid: str = "") -> None:
        """SSE: ML thread pushes deltas through call_soon_threadsafe."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_delta(piece: str) -> None:
            loop.call_soon_threadsafe(q.put_nowait, ("delta", piece))

        def on_meta(meta: dict) -> None:
            # admission metadata — the journal re-attach handle (jrid)
            # must reach the client BEFORE any crash can cut the stream
            loop.call_soon_threadsafe(q.put_nowait, ("meta", meta))

        def work():
            try:
                res = self.executor.generate_api(
                    gen, on_delta=on_delta, trace_id=rid, meta_cb=on_meta
                )
                loop.call_soon_threadsafe(q.put_nowait, ("done", res))
            except Exception as e:
                loop.call_soon_threadsafe(q.put_nowait, ("err", e))

        # not awaited on the timeout path: the generation thread cannot be
        # cancelled mid-decode, and holding the connection (and the caller's
        # inflight slot) for it would stall unrelated requests; the closure
        # keeps q alive, late puts are simply dropped with the queue
        loop.run_in_executor(self._pool, work)
        await self._send_sse_headers(writer)
        while True:
            try:
                kind, item = await asyncio.wait_for(
                    q.get(), STREAM_TOKEN_TIMEOUT
                )
            except asyncio.TimeoutError:
                writer.write(sse_event(fmt.error("stream token timeout", status=408)))
                writer.write(SSE_DONE)
                await writer.drain()
                return
            if kind == "delta":
                writer.write(sse_event(fmt.stream_chunk(item)))
                await writer.drain()
            elif kind == "meta":
                writer.write(sse_event(fmt.stream_prelude(item)))
                await writer.drain()
            elif kind == "done":
                writer.write(
                    sse_event(fmt.stream_final(
                        prompt_tokens=item["prompt_tokens"],
                        completion_tokens=item["completion_tokens"],
                        finish_reason=item["finish_reason"],
                        extra={
                            k: item[k] for k in ("jrid",) if k in item
                        } or None,
                    ))
                )
                writer.write(SSE_DONE)
                await writer.drain()
                return
            else:  # err
                writer.write(sse_event(fmt.error(str(item))))
                writer.write(SSE_DONE)
                await writer.drain()
                return

"""The port's node and API serving stack against the JAX package's, over
HTTP on 127.0.0.1.

Two clusters run side by side, each one validator (with the HTTP
endpoint) and one worker: the port's (``tensorlink_tpu_torch``, the
worker on the CPU through ``MLConfig(device="cpu")``) and the JAX
package's. Both host the same tiny float32 checkpoint (llama family,
vocab 258 for the byte tokenizer, 2 layers), written once by the port's
exporter and hosted by path, plus an int8-weight copy. The same requests
go to both: concurrent greedy ``/v1/generate``, streamed and plain
``/v1/chat/completions``, stop sequences, presence/frequency penalties,
beam search, lookahead, the int8-weight host and ``{"reattach": jrid}``
requests. Responses are equal in text, ``finish_reason`` and ``usage``
(the tiny greedy streams are token-equal across the packages, as in the
engine tests); ``/healthz``,
``/stats`` and ``/metrics`` expose the same serving modes, engine keys
and metric families, and the port's worker engine ran its chunks.
"""

import http.client
import json
import re
import shutil
import socket
import threading
import time

import pytest
import torch

from tensorlink_tpu_torch.engine.loader import export_hf
from tensorlink_tpu_torch.models import init_params
from tensorlink_tpu_torch.models.registry import config_from_hf

pytestmark = pytest.mark.e2e
torch.set_num_threads(1)

# tlint: disable=TL006(read-only test table — never mutated)
HF_CONFIG = {
    "model_type": "llama", "vocab_size": 258, "hidden_size": 64,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
    "max_position_embeddings": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
    "torch_dtype": "float32",
}
PACKAGES = ("port", "jax")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_api_ckpt")
    cfg = config_from_hf(HF_CONFIG, dtype=torch.float32)
    gen = torch.Generator("cpu")
    gen.manual_seed(11)
    export_hf(cfg, init_params(cfg, gen, "cpu"), root / "tiny",
              hf_config=HF_CONFIG)
    shutil.copytree(root / "tiny", root / "tiny-int8")
    return {"plain": str(root / "tiny"), "int8": str(root / "tiny-int8"),
            "config": cfg.to_json()}


def _start_cluster(pkg: str, tmp):
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.nodes.runners import ValidatorNode, WorkerNode

        ml = C.MLConfig(device="cpu")
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.nodes.runners import ValidatorNode, WorkerNode

        ml = C.MLConfig()
    common = dict(local_test=True, key_dir=str(tmp / "keys"),
                  log_dir=str(tmp / "logs"), env_file=str(tmp / ".env"),
                  ml=ml)
    v = ValidatorNode(C.ValidatorConfig(endpoint=True, endpoint_port=0,
                                        **common)).start()
    try:
        w = WorkerNode(C.WorkerConfig(
            seed_validators=[["127.0.0.1", v.port]],
            **{**common, "key_dir": str(tmp / "wkeys")})).start()
    except BaseException:
        v.stop()
        raise
    return v, w


@pytest.fixture(scope="module")
def clusters(checkpoint, tmp_path_factory):
    nodes = {}
    try:
        for pkg in PACKAGES:
            nodes[pkg] = _start_cluster(pkg, tmp_path_factory.mktemp(pkg))
        deadline = time.monotonic() + 30
        for v, _w in nodes.values():
            while not v.status()["peers"] and time.monotonic() < deadline:
                time.sleep(0.1)
        for pkg, (v, _w) in nodes.items():
            for name, quant in (("plain", None), ("int8", "int8")):
                body = {"hf_name": checkpoint[name], "seq_len": 256,
                        "config": checkpoint["config"]}
                if quant:
                    body["quant"] = quant
                status, out = _req(v.api.port, "POST", "/request-model", body)
                assert status == 200 and out["status"] == "ready", (pkg, out)
        yield {pkg: v for pkg, (v, _w) in nodes.items()}, nodes["port"][1]
    finally:
        for v, w in nodes.values():
            w.stop()
            v.stop()


def _req(port, method, path, body=None, timeout=120.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=payload, headers=(
        {"Content-Type": "application/json"} if payload else {}))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.getheader("Content-Type", "").startswith("application/json"):
        return resp.status, json.loads(data)
    return resp.status, data.decode()


def _sse(port, path, body, timeout=120.0) -> list:
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    payload = json.dumps(body).encode()
    s.sendall(
        f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
        f"\r\nContent-Length: {len(payload)}\r\n\r\n".encode() + payload)
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b" 200 " in head.split(b"\r\n")[0] and b"text/event-stream" in head
    return [blk.strip()[len("data: "):] for blk in rest.decode().split("\n\n")
            if blk.strip().startswith("data: ")]


def _answer(body: dict) -> tuple:
    """What must match across the clusters: text, finish reason, usage."""
    c = body["choices"][0]
    return c["message"]["content"], c["finish_reason"], body["usage"]


def _both(clusters, body, path="/v1/generate") -> dict:
    vs, _ = clusters
    out = {}
    for pkg, v in vs.items():
        status, resp = _req(v.api.port, "POST", path, body)
        assert status == 200, (pkg, resp)
        out[pkg] = resp
    assert _answer(out["port"]) == _answer(out["jax"]), out
    return out


def _greedy(ckpt, message, **kw):
    # the OpenAI shape carries finish_reason beside the text and usage
    return {"hf_name": ckpt, "message": message, "max_new_tokens": 16,
            "do_sample": False, "output_format": "openai", **kw}


def test_concurrent_greedy_generates_equal_jax(clusters, checkpoint):
    vs, _ = clusters
    msgs = ["the quick brown fox", "tensorlink serves", "a b c d e f g"]
    got = {pkg: {} for pkg in vs}

    def one(pkg, i):
        got[pkg][i] = _req(vs[pkg].api.port, "POST", "/v1/generate",
                           _greedy(checkpoint["plain"], msgs[i]))

    threads = [threading.Thread(target=one, args=(pkg, i))
               for pkg in vs for i in range(len(msgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for i in range(len(msgs)):
        (ps, pb), (js, jb) = got["port"][i], got["jax"][i]
        assert ps == js == 200, (pb, jb)
        assert _answer(pb) == _answer(jb)
        assert pb["usage"]["completion_tokens"] > 0


def test_streamed_chat_equals_jax_and_its_plain_run(clusters, checkpoint):
    vs, _ = clusters
    body = {"model": checkpoint["plain"], "max_tokens": 20,
            "temperature": 0.0,
            "messages": [{"role": "user", "content": "stream this please"}]}
    plain = _both(clusters, body, "/v1/chat/completions")
    streamed = {}
    for pkg, v in vs.items():
        events = _sse(v.api.port, "/v1/chat/completions",
                      {**body, "stream": True})
        assert events[-1] == "[DONE]", events
        chunks = [json.loads(e) for e in events[:-1]]
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks if c.get("choices"))
        finish = [c["choices"][0].get("finish_reason") for c in chunks
                  if c.get("choices")][-1]
        streamed[pkg] = (text, finish)
        # the deltas join to the plain request's text
        assert text == _answer(plain[pkg])[0]
    assert streamed["port"] == streamed["jax"]


def test_stop_sequences_equal_jax(clusters, checkpoint):
    base = _greedy(checkpoint["plain"], "stop somewhere in here",
                   max_new_tokens=24)
    text = _answer(_both(clusters, base)["port"])[0]
    stop = next((text[i:i + 2] for i in range(4, len(text) - 2)
                 if "�" not in text[i:i + 2]), text[-1:])
    out = _both(clusters, {**base, "stop": [stop]})
    assert _answer(out["port"])[1] == "stop"
    assert stop not in _answer(out["port"])[0]


def test_penalties_equal_jax(clusters, checkpoint):
    _both(clusters, _greedy(checkpoint["plain"], "penalize repeats repeats",
                            presence_penalty=0.6, frequency_penalty=0.4))


@pytest.mark.parametrize("kw", [{"num_beams": 3}, {"lookahead": True}],
                         ids=["beams", "lookahead"])
def test_static_paths_equal_jax(clusters, checkpoint, kw):
    _both(clusters, _greedy(checkpoint["plain"], "static engine paths", **kw))


def test_int8_weight_host_equals_jax(clusters, checkpoint):
    _both(clusters, _greedy(checkpoint["int8"], "int8 weights"))


def test_health_stats_and_metrics_match_jax(clusters, checkpoint):
    vs, port_worker = clusters
    # both hosts serve a request here, so the test needs no earlier one
    # (under xdist an earlier test may run on another process)
    for name in ("plain", "int8"):
        _both(clusters, _greedy(checkpoint[name], "fill the stats"))
    health, stats, families = {}, {}, {}
    for pkg, v in vs.items():
        status, health[pkg] = _req(v.api.port, "GET", "/healthz")
        assert status == 200
        assert set(health[pkg]["hosted_models"]) == {
            checkpoint["plain"], checkpoint["int8"]}
        status, body = _req(v.api.port, "GET", "/stats")
        assert status == 200
        stats[pkg] = {m["name"]: m for m in body["models"]}
        status, text = _req(v.api.port, "GET", "/metrics")
        assert status == 200
        families[pkg] = {
            line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE tlink_engine_")
        }
    assert health["port"]["serving_modes"] == health["jax"]["serving_modes"]
    modes = health["port"]["serving_modes"]
    assert modes[checkpoint["plain"]]["kv_quant"] == "int8"
    assert modes[checkpoint["int8"]]["weight_quant"] == "int8"
    for name in (checkpoint["plain"], checkpoint["int8"]):
        p, j = (stats[pkg][name]["serving"] for pkg in PACKAGES)
        assert p["mode"] == j["mode"] == "remote"
        assert set(p["engine"]) == set(j["engine"])
        assert p["engine"]["kv_quant"] == "int8"
        assert p["engine"]["kv_page_bytes"] == j["engine"]["kv_page_bytes"]
    assert families["port"] and families["port"] == families["jax"]
    # the port worker's slot engine ran the continuous requests
    conts = [rt.cont for rt in port_worker.executor.jobs.values()]
    assert conts and all(c is not None and c.chunks > 0 for c in conts)


def test_reattach_request_replays_or_regenerates_equal_jax(clusters,
                                                         checkpoint):
    """``{"reattach": jrid}`` on a live validator: the jrid of a finished
    stream replays it from the worker's orphan ledger, and an unknown
    jrid falls through to plain regeneration. Both answer the plain
    greedy request's text, as the JAX cluster does."""
    vs, _ = clusters
    body = _greedy(checkpoint["plain"], "re-attach me")
    plain = _both(clusters, body)
    unknown = _both(clusters, dict(body, reattach="ab12" * 8))
    for pkg, v in vs.items():
        assert _answer(unknown[pkg]) == _answer(plain[pkg])
        assert unknown[pkg]["jrid"] == "ab12" * 8
        status, replay = _req(v.api.port, "POST", "/v1/generate",
                              dict(body, reattach=plain[pkg]["jrid"]))
        assert status == 200, (pkg, replay)
        assert _answer(replay) == _answer(plain[pkg]), pkg
        assert replay["jrid"] == plain[pkg]["jrid"]


def test_port_network_processes_load_neither_torch_nor_jax(clusters):
    vs, port_worker = clusters
    for node in (vs["port"], port_worker):
        maps = open(f"/proc/{node._proc.pid}/maps").read()
        libs = {line.split()[-1] for line in maps.splitlines()
                if re.search(r"libtorch|libc10|jaxlib|xla_extension", line)}
        assert not libs, (node.role, sorted(libs))

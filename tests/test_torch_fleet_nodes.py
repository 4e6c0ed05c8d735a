"""Fleet serving and control-plane recovery over the port's node stack:
a port validator and two or three port workers (``MLConfig(device=
"cpu")``) on 127.0.0.1, hosting one tiny float32 llama from a seed.

Every stream is held token-equal to its uninterrupted run: an in-process
port ``ContinuousEngine`` over the worker's weights with the worker's
engine knobs, whose greedy tokens are themselves held equal to the JAX
package's engine on the same weights. The scenarios are the JAX
package's chaos tests (tests/test_chaos_e2e.py) on the port:

- ``fleet_replicas=2``: requests route over both replicas (``/fleet``);
- ``drain_worker`` mid-decode: every stream finishes equal, with at least
  one page-shipped migration and ``migrated + fell_back == n``, and the
  plan points at the destination afterwards;
- ``POST /fleet/deploy`` of ``r0`` under live streams: zero dropped;
- a prefill-role worker hands every stream to a decode-role worker;
- the validator crashes mid-decode and restarts on its journal: each
  stream re-attaches by jrid, complete and equal, twice;
- a restart mid-drain expires the staged ticket at the destination
  (``staged_migrations()`` empty, pages conserved at both endpoints).

Each test starts the cluster it needs, and every request has a timeout,
so the tests hold under ``pytest -n 6 --dist load`` in any order.
"""

import http.client
import json
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu_torch.core.config import (
    MLConfig,
    ValidatorConfig,
    WorkerConfig,
)
from tensorlink_tpu_torch.models.base import ModelConfig

pytestmark = pytest.mark.e2e
torch.set_num_threads(1)

CFG = ModelConfig(family="llama", vocab_size=258, d_model=64, n_layers=2,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  max_seq_len=256, dtype=torch.float32)
SEED = 3
TIMEOUT = 120.0  # every cluster request
# tlint: disable=TL006(read-only test data)
MESSAGES = ["alpha", "beta bravo", "gamma ray", "delta"]
N_TOKENS = 96


# -- the uninterrupted reference -------------------------------------------
def _prompt_ids(message: str, n: int):
    """The ids and budget the validator's ``generate_api`` derives from a
    greedy request (chat formatting, byte tokenizer)."""
    from tensorlink_tpu_torch.api.formatter import (
        format_chat_prompt,
        normalize_generate_args,
    )
    from tensorlink_tpu_torch.api.tokenizer import load_tokenizer

    req = _request("fleet-tiny", message, n)
    tok = load_tokenizer({"name": "fleet-tiny"})
    prompt = format_chat_prompt(
        req.message, req.history,
        tokenizer=tok if tok.chat_template else None,
        model_name=req.hf_name, enable_thinking=req.enable_thinking)
    ids = tok.encode(prompt)
    args = normalize_generate_args(req, prompt_len=len(ids),
                                   max_context=min(256, tok.model_max_length))
    return tok, ids, int(args["max_new_tokens"])


def _engine_tokens(pkg: str, params, prompts, budgets):
    """Greedy tokens of each prompt alone on a slot engine built with the
    worker's default knobs, in ``pkg``."""
    if pkg == "port":
        from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
        from tensorlink_tpu_torch.engine.generate import GenerationEngine

        ml = MLConfig(device="cpu")
        gen = GenerationEngine(CFG, params, max_seq_len=256,
                               seq_buckets=ml.seq_buckets,
                               batch_buckets=ml.batch_buckets, device="cpu")
    else:
        from tensorlink_tpu.core.config import MLConfig as JMLConfig
        from tensorlink_tpu.engine.continuous import ContinuousEngine
        from tensorlink_tpu.engine.generate import GenerationEngine
        from tensorlink_tpu.models import ModelConfig as JModelConfig

        ml = JMLConfig()
        jcfg = JModelConfig.from_json({**CFG.to_json(), "dtype": "float32"})
        gen = GenerationEngine(jcfg, params, max_seq_len=256,
                               seq_buckets=ml.seq_buckets,
                               batch_buckets=ml.batch_buckets)
    out = []
    for ids, n in zip(prompts, budgets):
        ce = ContinuousEngine(
            gen, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
            chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
            kv_quant=ml.kv_quant, spec_decode=ml.spec_decode,
            spec_draft=ml.spec_draft)
        req = ce.submit(list(ids), max_new_tokens=n, seed=0)
        ce.run_until_idle()
        out.append([int(t) for t in req.tokens])
        ce.close()
    return out


@pytest.fixture(scope="module")
def reference():
    """message -> the text ``generate_api`` must answer: the port slot
    engine's greedy stream over the worker's seeded weights, held equal
    to the JAX engine's on the same weights."""
    from tensorlink_tpu_torch.api.formatter import extract_reasoning_and_answer
    from tensorlink_tpu_torch.models.transformer import init_params

    gen = torch.Generator("cpu")
    gen.manual_seed(SEED)
    params = init_params(CFG, gen, "cpu")
    jparams = _tree(params, lambda t: jnp.asarray(t.numpy()))
    prompts, budgets, toks = [], [], None
    for m in MESSAGES:
        tok, ids, n = _prompt_ids(m, N_TOKENS)
        prompts.append(ids)
        budgets.append(n)
    port = _engine_tokens("port", params, prompts, budgets)
    assert port == _engine_tokens("jax", jparams, prompts, budgets)
    eos = set(tok.eos_ids)
    toks = {}
    for m, ids in zip(MESSAGES, port):
        _, answer = extract_reasoning_and_answer(
            tok.decode([i for i in ids if i not in eos]))
        toks[m] = answer
    return toks


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# -- clusters ----------------------------------------------------------------
def _request(name, message, n, reattach=""):
    from tensorlink_tpu_torch.api.schemas import GenerationRequest

    body = {"hf_name": name, "message": message, "max_new_tokens": n,
            "temperature": 0.0, "do_sample": False}
    if reattach:
        body["reattach"] = reattach
    return GenerationRequest.parse(body)


def _validator(tmp: Path, ml: MLConfig, endpoint=False):
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode

    return ValidatorNode(ValidatorConfig(
        endpoint=endpoint, endpoint_port=0, monitor_interval=0.5,
        keeper_interval=5.0, proposal_interval=0.0, local_test=True,
        key_dir=str(tmp / "keys"), log_dir=str(tmp / "logs"),
        env_file=str(tmp / ".env"), ml=ml)).start()


def _cluster(tmp: Path, *, n_workers=2, vml=None, wml=None, faults=None,
             endpoint=False, caps=(8e9, 4e9, 2e9)):
    """A port validator and ``n_workers`` port workers on 127.0.0.1,
    their capacities pinned so the planner's order is known."""
    from tensorlink_tpu_torch.nodes.runners import WorkerNode

    v = _validator(tmp, vml or MLConfig(device="cpu"), endpoint=endpoint)
    workers = []
    try:
        for i in range(n_workers):
            workers.append(WorkerNode(WorkerConfig(
                seed_validators=[["127.0.0.1", v.port]],
                duplicate=str(i) if i else "", local_test=True,
                key_dir=str(tmp / "keys"), log_dir=str(tmp / "logs"),
                env_file=str(tmp / ".env"),
                faults=(faults or {}).get(i, {}),
                ml=(wml or {}).get(i) or MLConfig(device="cpu"))).start())
        deadline = time.monotonic() + 30
        while (len(v.status()["peers"]) < n_workers
               and time.monotonic() < deadline):
            time.sleep(0.1)
        for w, cap in zip(workers, caps):
            w.send_request("set_capacity", {"hbm_bytes": cap, "n_devices": 1})
    except BaseException:
        _stop([*workers, v])
        raise
    return v, workers


def _stop(nodes):
    """Stop every node at once: a worker whose validator crashed takes
    its network process's full join timeout to stop."""
    def one(n):
        try:
            n.stop()
        except Exception:  # noqa: BLE001 — teardown of a crashed node
            pass

    threads = [threading.Thread(target=one, args=(n,)) for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)


def _host(v, name="fleet-tiny"):
    job = v.executor.host_model(name, config=CFG.to_json(), seq_len=256,
                                seed=SEED)
    assert job.status == "ready", job.error
    return job


def _streams(v, messages, name="fleet-tiny", n=N_TOKENS):
    """One streamed ``generate_api`` per message on a thread: the texts
    streamed, the jrids from the admission callback, the answers and the
    errors."""
    k = len(messages)
    st = {"texts": [[] for _ in range(k)], "jrids": [None] * k,
          "outs": [None] * k, "errors": [None] * k}

    def go(i):
        try:
            st["outs"][i] = v.executor.generate_api(
                _request(name, messages[i], n),
                on_delta=st["texts"][i].append,
                meta_cb=lambda m, i=i: st["jrids"].__setitem__(
                    i, str(m.get("jrid") or "")))
        except BaseException as e:  # noqa: BLE001 — asserted by the test
            st["errors"][i] = e

    st["threads"] = [threading.Thread(target=go, args=(i,), daemon=True)
                     for i in range(k)]
    for t in st["threads"]:
        t.start()
        time.sleep(0.02)
    return st


def _join(st, timeout=TIMEOUT):
    for t in st["threads"]:
        t.join(timeout)
    assert not any(t.is_alive() for t in st["threads"]), "a stream hung"


def _wait(pred, what, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data, headers=(
        {"Content-Type": "application/json"} if data else {}))
    resp = conn.getresponse()
    out = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, out


def _entry(rep) -> str:
    """The worker a replica's requests enter at."""
    return rep["model"].plan.stages[0].worker_id


def _engines(w):
    return [rt.cont for rt in list(w.executor.jobs.values())
            if rt.cont is not None]


# -- the scenarios -------------------------------------------------------
def test_fleet_routes_over_both_replicas(tmp_path, reference):
    v, ws = _cluster(tmp_path, endpoint=True, caps=(4e9, 4e9),
                     vml=MLConfig(device="cpu", fleet_replicas=2))
    try:
        job = _host(v)
        assert {_entry(r) for r in job.replicas} == {w.node_id for w in ws}
        st = _streams(v, MESSAGES * 2)
        _join(st)
        assert st["errors"] == [None] * 8, st["errors"]
        assert [o["text"] for o in st["outs"]] == [
            reference[m] for m in MESSAGES * 2]
        status, fleet = _http(v.api.port, "GET", "/fleet")
        fleet = fleet["fleet"]
        assert status == 200
        routed = {rid: r["routed"] for rid, r in
                  fleet["fleet-tiny"]["router"]["replicas"].items()}
        assert fleet["fleet-tiny"]["replicas"] == 2
        assert sum(routed.values()) == 8 and min(routed.values()) >= 1, routed
        assert all(c.chunks > 0 for w in ws for c in _engines(w))
        status, hz = _http(v.api.port, "GET", "/healthz")
        assert set(hz["headroom"]["fleet-tiny"]) == {"r0", "r1"}
    finally:
        _stop([*ws, v])


def test_drain_mid_decode_migrates_every_stream(tmp_path, reference):
    v, ws = _cluster(tmp_path)
    try:
        job = _host(v)
        assert job.model.plan.stages[0].worker_id == ws[0].node_id
        st = _streams(v, MESSAGES)
        _wait(lambda: all(len(t) >= 4 for t in st["texts"]),
              "steady decode")
        summary = v.send_request(
            "drain_worker", {"worker": ws[0].node_id, "dest": ws[1].node_id},
            timeout=TIMEOUT)
        _join(st)
        assert st["errors"] == [None] * 4, st["errors"]
        assert summary["ok"], summary
        assert summary["migrated"] >= 1, summary
        assert summary["migrated"] + summary["fell_back"] == 4, summary
        for m, out, texts in zip(MESSAGES, st["outs"], st["texts"]):
            assert out["text"] == reference[m] == "".join(texts), m
        # the plan points at the destination, which adopted the shipped
        # pages and holds none in transit
        assert job.model.plan.stages[0].worker_id == ws[1].node_id
        [dest] = _engines(ws[1])
        assert int(dest.stats["migrations_adopted"]) == summary["migrated"]
        assert dest.serving_snapshot()["pages_in_transit"] == 0
        dest.check_page_conservation()
    finally:
        _stop([*ws, v])


def test_rolling_deploy_under_live_streams_drops_none(tmp_path, reference):
    v, ws = _cluster(
        tmp_path, n_workers=3, endpoint=True, caps=(4e9, 4e9, 4e9),
        vml=MLConfig(device="cpu", fleet_replicas=2,
                     fleet_autopilot_interval_s=0.2))
    try:
        job = _host(v)
        old_r0 = job.replicas[0]["job_id"]
        serving = {_entry(r) for r in job.replicas}
        assert len(serving) == 2
        st = _streams(v, MESSAGES)
        _wait(lambda: all(len(t) >= 2 for t in st["texts"]),
              "steady decode")
        status, out = _http(v.api.port, "POST", "/fleet/deploy",
                            {"model": "fleet-tiny", "replicas": ["r0"]})
        assert status == 200 and out["ok"], out

        def deployed():
            _, fleet = _http(v.api.port, "GET", "/fleet")
            fleet = fleet["fleet"]
            hist = fleet["fleet-tiny"]["autopilot"]["history"]
            return any(h["kind"] == "deploy_done" for h in hist)

        _wait(deployed, "deploy_done", deadline_s=TIMEOUT)
        _join(st)
        assert st["errors"] == [None] * 4, st["errors"]
        assert [o["text"] for o in st["outs"]] == [reference[m]
                                                   for m in MESSAGES]
        # r0 was rebuilt on the third worker (the drained one stays
        # fenced), and serves
        assert job.replicas[0]["job_id"] != old_r0
        assert _entry(job.replicas[0]) not in serving
        again = v.executor.generate_api(
            _request("fleet-tiny", MESSAGES[0], N_TOKENS))
        assert again["text"] == reference[MESSAGES[0]]
    finally:
        _stop([*ws, v])


def test_prefill_worker_hands_streams_to_decode_worker(tmp_path, reference):
    v, ws = _cluster(tmp_path, wml={
        0: MLConfig(device="cpu", worker_role="prefill"),
        1: MLConfig(device="cpu", worker_role="decode")})
    try:
        job = _host(v)
        assert job.model.plan.stages[0].worker_id == ws[0].node_id
        st = _streams(v, MESSAGES)
        _join(st)
        assert st["errors"] == [None] * 4, st["errors"]
        assert [o["text"] for o in st["outs"]] == [reference[m]
                                                   for m in MESSAGES]
        # the admission point stays the prefill worker
        assert job.model.plan.stages[0].worker_id == ws[0].node_id
        [pre], [dec] = _engines(ws[0]), _engines(ws[1])
        assert int(pre.stats["handoffs_completed"]) >= 1
        assert int(dec.stats["migrations_adopted"]) >= 1
        for ce in (pre, dec):
            assert ce.serving_snapshot()["pages_in_transit"] == 0
            ce.check_page_conservation()
    finally:
        _stop([*ws, v])


def test_validator_crash_mid_decode_reattaches_every_stream(tmp_path,
                                                           reference):
    from tensorlink_tpu_torch.core.journal import ControlJournal

    v, ws = _cluster(tmp_path, n_workers=1)
    restarted = None
    try:
        _host(v)
        st = _streams(v, MESSAGES[:2])
        _wait(lambda: all(st["jrids"]) and all(st["texts"]), "streams")
        v.crash()  # the control plane dies mid-decode
        for t in st["threads"]:
            t.join(5)
        restarted = _validator(tmp_path, MLConfig(device="cpu"))
        _wait(lambda: (
            getattr(restarted.executor.hosted.get("fleet-tiny"), "status",
                    "") == "ready" and not restarted.executor.recovering),
            "journal replay", deadline_s=TIMEOUT)
        st2 = ControlJournal.replay(
            Path(restarted.config.log_dir) / "control_journal.jsonl")
        assert st2.recovered >= 1
        for m, jrid in zip(MESSAGES[:2], st["jrids"]):
            deltas: list = []
            out = restarted.executor.generate_api(
                _request("fleet-tiny", m, N_TOKENS, reattach=jrid),
                on_delta=deltas.append)
            assert out["jrid"] == jrid
            assert out["text"] == reference[m] == "".join(deltas), m
            # the first re-attach drained the orphan ledger; the second
            # regenerates, equal all the same
            again = restarted.executor.generate_api(
                _request("fleet-tiny", m, N_TOKENS, reattach=jrid))
            assert again["text"] == reference[m]
    finally:
        _stop([*ws, *(x for x in (restarted, v) if x is not None)])


def test_validator_restart_mid_drain_expires_staged_tickets(tmp_path):
    from tensorlink_tpu_torch.core.journal import ControlJournal

    def staged(w):
        return [m for ce in _engines(w) for m in ce.staged_migrations()]

    # every page transfer stretched so the validator dies inside one
    v, ws = _cluster(tmp_path, faults={0: {"seed": 9, "rules": [
        {"site": "migrate.wire", "op": "delay", "delay_s": 4.0,
         "prob": 1.0, "max_fires": None}]}})
    restarted = None
    try:
        job = _host(v)
        st = _streams(v, MESSAGES[:2], n=160)
        _wait(lambda: all(st["texts"]), "steady decode")
        rep = job.replicas[0]
        addr = {w.node_id: ["127.0.0.1", w.port] for w in ws}
        iid_mig = v.executor._jintent("mig", {
            "name": "fleet-tiny", "rid": "r0", "src": ws[0].node_id,
            "dest": ws[1].node_id, "job_id": rep["job_id"],
            "src_addr": addr[ws[0].node_id],
            "dest_addr": addr[ws[1].node_id]})
        iid_act = v.executor._jintent("action", {
            "verb": "deploy", "rid": "r0", "name": "fleet-tiny"})

        def issue_drain():
            try:
                v.send_request("drain_worker", {"worker": ws[0].node_id,
                                                "dest": ws[1].node_id},
                               timeout=TIMEOUT)
            except Exception:  # noqa: BLE001 — the validator dies under it
                pass

        threading.Thread(target=issue_drain, daemon=True).start()
        time.sleep(1.5)  # the first slot exported, its transfer delayed
        v.crash()
        for t in st["threads"]:
            t.join(5)
        # the worker's drain outlives the validator: the pages stage at
        # the destination with nobody left to adopt them
        _wait(lambda: staged(ws[1]), "a ticket staged at the destination")
        restarted = _validator(tmp_path, MLConfig(device="cpu"))
        jpath = Path(restarted.config.log_dir) / "control_journal.jsonl"
        _wait(lambda: ControlJournal.replay(jpath).intents[iid_mig]["state"]
              != "intent", "ticket expiry", deadline_s=TIMEOUT)
        state = ControlJournal.replay(jpath)
        close = state.intents[iid_mig]["close_data"] or {}
        assert state.intents[iid_mig]["state"] == "abort"
        assert close.get("recovery") == "expired", close
        assert int(close.get("expired", 0)) >= 1, close
        assert state.intents[iid_act]["state"] == "abort"
        assert not staged(ws[1])
        for w in ws:
            for ce in _engines(w):
                ce.check_page_conservation()
    finally:
        _stop([*ws, *(x for x in (restarted, v) if x is not None)])

"""The node stack's host-side layers in the port against the JAX package on
the same inputs, one parametrised test per layer:

- a P2P frame (control JSON or a TLTS bulk blob) encodes to the same
  bytes in both packages and decodes in the other;
- an identity of either package signs and the other verifies;
- ``NodeConfig``/``MLConfig`` dicts and their round trips are equal
  (the port's ``MLConfig.device`` aside), operator config files too;
- control-journal files are equal record for record (wall-clock ``t`` and
  the random intent ids aside) and replay equal in either package;
- ``plan_sharding`` gives equal plans for the same capacities and config;
- the API formatter and schemas give equal outputs.

Then the port's own contracts: a worker with ``device=None`` refuses to
start on a host with no card, naming the card, and every verb a later
slice ports is answered with an error naming its ROADMAP item.
"""

import dataclasses
import json
import queue
import types

import numpy as np
import pytest
import torch

from tensorlink_tpu.api import formatter as jfmt
from tensorlink_tpu.api import schemas as jschemas
from tensorlink_tpu.core import config as jconfig
from tensorlink_tpu.core import serialization as jser
from tensorlink_tpu.core.journal import ControlJournal as JJournal
from tensorlink_tpu.crypto import identity as jid
from tensorlink_tpu.models.registry import config_presets as jpresets
from tensorlink_tpu.p2p import protocol as jproto
from tensorlink_tpu.parallel import planner as jplanner
from tensorlink_tpu_torch.api import formatter as tfmt
from tensorlink_tpu_torch.api import schemas as tschemas
from tensorlink_tpu_torch.core import config as tconfig
from tensorlink_tpu_torch.core import serialization as tser
from tensorlink_tpu_torch.core.journal import ControlJournal as TJournal
from tensorlink_tpu_torch.crypto import identity as tid
from tensorlink_tpu_torch.models.registry import config_presets as tpresets
from tensorlink_tpu_torch.p2p import protocol as tproto
from tensorlink_tpu_torch.parallel import planner as tplanner

torch.set_num_threads(1)


# -- P2P frames ----------------------------------------------------------
_RNG = np.random.default_rng(7)
# tlint: disable=TL006(read-only test table — never mutated)
FRAMES = {
    "control job.req": (jproto.CONTROL, "job.req",
                        {"spec": {"model": {"name": "m"}, "batch": 2}}),
    "control gen": (jproto.CONTROL, "gen",
                    {"job_id": "ab", "prompts": [[1, 2, 3]], "top_p": 0.9,
                     "stream": "s1", "eos_ids": [257]}),
    "control token": (jproto.CONTROL, "token",
                      {"stream": "s1", "tokens": [[0, 42]], "done": False}),
    "bulk arrays": (jproto.BULK, "fwd",
                    {"x": _RNG.standard_normal((3, 5)).astype(np.float32),
                     "ids": np.arange(7, dtype=np.int32),
                     "meta": {"n": 3, "t": (1, "a")}}),
    "bulk empty": (jproto.BULK, "params", {}),
}


def _frame(proto, ser, kind, tag, body) -> bytes:
    if kind == proto.CONTROL:
        kind, tag, payload = proto.control(tag, body)
    else:
        payload = bytes(ser.encode(body))
    return proto.pack_header(kind, tag, len(payload)) + payload


def _parse(proto, ser, frame: bytes):
    hdr = proto.unpack_header(frame[: proto.HEADER_SIZE])
    rest = frame[proto.HEADER_SIZE:]
    tag = rest[: hdr.tag_len].decode("ascii")
    payload = rest[hdr.tag_len: hdr.tag_len + hdr.payload_len]
    if hdr.kind == proto.CONTROL:
        return hdr.kind, tag, proto.parse_control(payload)
    return hdr.kind, tag, ser.decode(payload, copy=True)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("name", list(FRAMES))
def test_p2p_frames_equal_and_cross_decode(name):
    kind, tag, body = FRAMES[name]
    jframe = _frame(jproto, jser, kind, tag, body)
    tframe = _frame(tproto, tser, kind, tag, body)
    assert jframe == tframe
    assert tproto.HEADER_SIZE == jproto.HEADER_SIZE
    for proto, ser in ((tproto, tser), (jproto, jser)):
        k, t, got = _parse(proto, ser, jframe)
        assert (k, t) == (kind, tag)
        _same(got, json.loads(json.dumps(body)) if kind == 0 else body)


# -- identity ------------------------------------------------------------
@pytest.mark.parametrize("signer", ["port", "jax"])
def test_identity_signs_and_the_other_package_verifies(signer, tmp_path):
    mods = {"port": tid, "jax": jid}
    sign_mod = mods[signer]
    verify_mod = mods["jax" if signer == "port" else "port"]
    me = sign_mod.load_or_create_identity("worker", tmp_path)
    # the other package reads the same key files as the same node
    again = verify_mod.load_or_create_identity("worker", tmp_path)
    assert again.node_id == me.node_id == verify_mod.node_id_from_public_key(
        me.public_pem)
    msg = b"challenge nonce 1234"
    sig = sign_mod.sign(me, msg)
    assert verify_mod.verify(me.public_pem, sig, msg)
    assert not verify_mod.verify(me.public_pem, sig, msg + b"x")
    assert verify_mod.authenticate_public_key(me.public_pem)
    assert verify_mod.decrypt(again, sign_mod.encrypt(me.public_pem, b"k")) \
        == b"k"


# -- configs -------------------------------------------------------------
# tlint: disable=TL006(read-only test table — never mutated)
ROLES = ["NodeConfig", "WorkerConfig", "ValidatorConfig", "UserConfig"]


def _without_device(d: dict) -> dict:
    d = dict(d, ml=dict(d["ml"]))
    assert d["ml"].pop("device", "absent") is None
    return d


@pytest.mark.parametrize("role", ROLES)
def test_config_dicts_and_round_trips_equal(role):
    jcls, tcls = getattr(jconfig, role), getattr(tconfig, role)
    kw = dict(port=4242, local_test=True, seed_validators=[("127.0.0.1", 9)],
              ml=None, faults={"p2p.send": {"every": 3}})
    jc = jcls(**{**kw, "ml": jconfig.MLConfig(kv_quant="int4",
                                              cont_max_slots=4)})
    tc = tcls(**{**kw, "ml": tconfig.MLConfig(kv_quant="int4",
                                              cont_max_slots=4)})
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert _without_device(td) == jd
    # round trips through each package's coercion, in both directions
    assert dataclasses.asdict(jconfig._coerce(jcls, jd)) == jd
    assert _without_device(dataclasses.asdict(tconfig._coerce(tcls, jd))) == jd
    assert dataclasses.asdict(tconfig._coerce(tcls, td)) == td
    assert tconfig._coerce(tcls, {**td, "ml": {"device": "cpu"}}).ml.device \
        == "cpu"


@pytest.mark.parametrize("mode", ["local", "upnp", "on_chain", None])
def test_operator_config_files_load_equal(mode, tmp_path):
    raw = {"node": {"type": "validator", "endpoint_port": 0},
           "ml": {"max_seq_len": 512, "kv_quant": "none"}}
    if mode:
        raw["mode"] = mode
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    assert type(jc).__name__ == type(tc).__name__
    assert _without_device(dataclasses.asdict(tc)) == dataclasses.asdict(jc)


# -- control journal -----------------------------------------------------
def _journal_script(j) -> None:
    j.append("replica_up", {"name": "m", "rid": "r0", "job_id": "j1",
                            "attach": {"plan": {"stages": []}}}, flush=True)
    iid = j.intent("host", {"name": "m", "spec": {"name": "m", "seed": 0}})
    j.append("admit", {"jrid": "a1", "model": "m", "n_prompt": 5})
    j.append("seed", {"jrid": "a1", "seed": 3})
    j.append("hwm", {"jrid": "a1", "n": 16})
    j.append("admit", {"jrid": "a2", "model": "m", "n_prompt": 9})
    j.append("finish", {"jrid": "a2", "n": 4, "reason": "stop"})
    j.commit(iid, {"replicas": 1})
    j.abort(j.intent("mig", {"name": "m", "src": "w0"}), {"error": "x"})
    j.append("unhost", {"name": "gone"}, flush=True)
    j.close()


def _normalized(path) -> list[dict]:
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    iids: dict = {}
    for r in recs:
        assert isinstance(r.pop("t"), float)
        if "iid" in r:
            r["iid"] = iids.setdefault(r["iid"], len(iids))
    return recs


def _state(st) -> dict:
    d = dataclasses.asdict(st)
    order = {iid: i for i, iid in enumerate(d["intents"])}
    d["intents"] = {order[k]: v for k, v in d["intents"].items()}
    return d


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_journal_records_equal_and_replay_across_packages(reader, tmp_path):
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _journal_script(JJournal(jpath, flush_every=4, flush_s=60.0))
    _journal_script(TJournal(tpath, flush_every=4, flush_s=60.0))
    assert _normalized(tpath) == _normalized(jpath)
    replay = (TJournal if reader == "port" else JJournal).replay
    want = _state(JJournal.replay(jpath))
    assert _state(replay(jpath)) == want
    assert _state(replay(tpath)) == want
    st = replay(tpath)
    assert sorted(st.live_jobs()) == ["m"]
    assert [jr for jr, _ in st.orphan_admissions()] == ["a1"]


# -- planner -------------------------------------------------------------
# tlint: disable=TL006(read-only test table — never mutated)
PLANS = {
    "qwen3-0p6b one card": ("qwen3-0p6b", [80e9], {}),
    "qwen3-8b best of three": ("qwen3-8b", [8e9, 40e9, 80e9], {}),
    "llama3-70b pipeline": ("llama3-70b", [80e9] * 4, {}),
    "gemma-7b tied split": ("gemma-7b", [12e9, 12e9], {}),
    "qwen3-1p7b training": ("qwen3-1p7b", [(320e9, 4)],
                            dict(training=True, batch=4, seq_len=1024)),
    "mixtral expert axis": ("mixtral-8x7b", [(640e9, 8)], {}),
    "qwen3-4b multi-device": ("qwen3-4b", [(160e9, 4)], dict(batch=8)),
    "too small": ("qwen3-8b", [1e9, 1e9], {}),
}


def _caps(mod, spec):
    out = []
    for i, c in enumerate(spec):
        hbm, n = c if isinstance(c, tuple) else (c, 1)
        out.append(mod.WorkerCapacity(node_id=f"w{i}", hbm_bytes=hbm,
                                      n_devices=n))
    return out


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_sharding_equal_plans(case):
    name, caps, kw = PLANS[case]
    outs = []
    for mod, presets in ((jplanner, jpresets), (tplanner, tpresets)):
        try:
            plan = mod.plan_sharding(presets()[name], _caps(mod, caps),
                                     model_name=name, **kw)
            outs.append(plan.to_json())
        except mod.AssignmentError as e:
            outs.append(("refused", str(e)))
    assert outs[1] == outs[0]
    assert isinstance(outs[1], tuple) == (case == "too small")
    if case != "too small":
        plan = tplanner.ShardingPlan.from_json(outs[1])
        assert plan.to_json() == outs[0]
        assert plan.stages[0].first and plan.stages[-1].last


# -- API formatter and schemas -------------------------------------------
def _formatter_case(mod, case: str):
    if case == "normalize":
        req = mod.schemas.GenerationRequest.parse({
            "hf_name": "m", "message": "hi", "max_new_tokens": 900,
            "do_sample": True, "temperature": 0.7, "top_p": 0.5,
            "presence_penalty": 0.3})
        return mod.fmt.normalize_generate_args(req, prompt_len=700,
                                               max_context=1024)
    if case == "chat prompt":
        return [mod.fmt.format_chat_prompt(
            "hello", [{"role": "user", "content": "a"},
                      {"role": "assistant", "content": "b"}],
            tokenizer=None, model_name=n, enable_thinking=t)
            for n in ("qwen3-0p6b", "llama", "") for t in (False, True)]
    if case == "reasoning":
        return [mod.fmt.extract_reasoning_and_answer(s) for s in (
            "<think>plan</think>answer", "no think", "<think>open",
            "x</think>y")]
    if case == "stop stream":
        out = []
        s = mod.fmt.StopStream(["END", "\n\n"], out.append)
        for piece in ("abc E", "N", "D more", "\n", "\nx"):
            s.feed(piece)
        s.flush()
        return out, s.stopped
    if case == "think strip":
        s = mod.fmt.ThinkStripStream()
        got = [s.feed(p) for p in ("<thi", "nk>secret</th", "ink>vis", "ible")]
        return got, s.flush()
    if case == "response shapes":
        outs = []
        for fmt in ("simple", "openai", "raw"):
            f = mod.fmt.ResponseFormatter("m", fmt)
            f.id, f.created = "chatcmpl-x", 1
            outs.append(f.complete("text", prompt_tokens=3,
                                   completion_tokens=4, reasoning="r",
                                   finish_reason="length",
                                   extra={"jrid": "j"}))
        return outs, mod.fmt.sse_event({"a": 1}), mod.fmt.SSE_DONE
    if case == "schemas":
        chat = mod.schemas.ChatCompletionRequest.parse({
            "model": "m", "stream": True, "stop": "x", "max_tokens": 9,
            "messages": [{"role": "system", "content": "s"},
                         {"role": "user", "content": "q"}]})
        job = mod.schemas.JobRequest.parse({"hf_name": "m", "quant": "int8"})
        bad = []
        for body in ({}, {"hf_name": "m", "top_p": 0.0},
                     {"hf_name": "m", "output_format": "xml"}):
            try:
                mod.schemas.GenerationRequest.parse(body)
            except mod.schemas.ValidationError as e:
                bad.append(str(e))
        return (dataclasses.asdict(chat.to_generation_request()),
                dataclasses.asdict(job), bad)
    raise AssertionError(case)


# tlint: disable=TL006(read-only test table — never mutated)
FORMATTER_CASES = ["normalize", "chat prompt", "reasoning", "stop stream",
                   "think strip", "response shapes", "schemas"]


@pytest.mark.parametrize("case", FORMATTER_CASES)
def test_formatter_and_schemas_equal(case):
    jmod = types.SimpleNamespace(fmt=jfmt, schemas=jschemas)
    tmod = types.SimpleNamespace(fmt=tfmt, schemas=tschemas)
    assert _formatter_case(tmod, case) == _formatter_case(jmod, case)


# -- batchers over a remote model ----------------------------------------
class _FakeModel:
    """A single-stage DistributedModel stand-in: records each generate
    call and answers a deterministic stream per prompt."""

    def __init__(self):
        self.plan = types.SimpleNamespace(n_stages=1)
        self.model_spec = {"quant": "int8"}
        self.calls = []

    def generate(self, prompts, **kw):
        cb = kw.pop("stream_cb", None)
        self.calls.append((prompts, kw))
        out = [[(sum(p) + 7 * j) % 251 for j in range(6)] for p in prompts]
        if cb is not None:
            for j in range(6):
                cb([row[j] for row in out])
        return out


def _drive_batcher(batching, mode):
    model = _FakeModel()
    if mode == "static":
        b = batching.GenBatcher(model, [257], max_batch=1, seed=3)
    else:
        b = batching.ContinuousBatcher(model, [257], seed=3,
                                       kv_quant="int8", spec_decode=True)
    streamed = []
    outs = [b.generate([1, 2, i], max_new_tokens=5, temperature=0.5 * i,
                       top_k=4, presence_penalty=0.1 * i,
                       stream_cb=streamed.append, trace_id=f"t{i}")
            for i in range(3)]
    snap = (b.router_snapshot(), b.admission_check("batch"), b.stats())
    modes = b.serving_modes() if mode == "remote" else None
    b.close(timeout=10)
    return outs, streamed, model.calls, snap, modes


@pytest.mark.parametrize("mode", ["static", "remote"])
def test_batchers_over_a_remote_model_equal_jax(mode):
    from tensorlink_tpu.ml import batching as jbatching
    from tensorlink_tpu_torch.ml import batching as tbatching

    assert _drive_batcher(tbatching, mode) == _drive_batcher(jbatching, mode)


# -- the port's own contracts --------------------------------------------
def test_worker_without_a_card_refuses_to_start(tmp_path):
    from tensorlink_tpu_torch.nodes.runners import WorkerNode

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs a host "
                    "without one")
    node = WorkerNode(tconfig.WorkerConfig(
        local_test=True, key_dir=str(tmp_path / "k"),
        log_dir=str(tmp_path / "l"), env_file=str(tmp_path / ".env")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.start()
    assert node._proc is None  # no network process was left behind
    node.stop()


class _Bridge:
    """The ML side of the IPC bridge: work items in, responses recorded."""

    def __init__(self, items):
        self.q = types.SimpleNamespace(work=queue.Queue())
        for it in items:
            self.q.work.put(it)
        self.q.work.put(("_stop", None))
        self.sent = []

    def get_work(self, timeout=None):
        return self.q.work.get(timeout=timeout)

    def request(self, verb, payload=None, timeout=None):
        self.sent.append((verb, payload))


# tlint: disable=TL006(read-only test table — never mutated)
_VERBS = {
    "fwd": 8, "bwd": 9, "opt": 9, "proof.req": 9, "ckpt": 9,
    "params.req": 9, "train.mode": 9, "drain": 7, "mig": 7, "handoff": 7,
    "replica.set": 7,
}


@pytest.mark.parametrize("verb", list(_VERBS))
def test_unported_worker_verb_answers_with_its_roadmap_item(verb):
    from tensorlink_tpu_torch.ml.worker import DistributedWorker

    bridge = _Bridge([(verb, {"rid": "r1", "peer": "p1", "job_id": "j"})])
    node = types.SimpleNamespace(
        bridge=bridge, node_id="w0",
        config=tconfig.WorkerConfig(ml=tconfig.MLConfig(device="cpu")))
    DistributedWorker(node).run()
    [(kind, body)] = bridge.sent
    assert kind == "respond" and body["rid"] == "r1" and body["peer"] == "p1"
    err = body["body"]["error"]
    assert err.startswith("NotImplementedError")
    assert f"ROADMAP queue 1 item {_VERBS[verb]}" in err

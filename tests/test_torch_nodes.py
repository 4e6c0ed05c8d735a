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
start on a host with no card, naming the card; a session FORWARD on a
layer-slice stage is answered as the JAX worker answers it (a duplicated
seq from the ledger), and a stage a later slice ports (a device mesh,
co-slice coworkers) with an error naming its ROADMAP item. Each training verb (fwd, bwd, opt, proof.req, ckpt, params.req,
train.mode) sent to a bare worker holding a tiny training job is answered
as the JAX worker answers it. Each fleet verb (drain, mig, handoff,
replica.set) between two bare workers wired together in process is
answered as between two JAX workers, and the streams it moves resume at
the destination equal to their unmoved run; a re-attach rebinds a live
stream and replays a finished one as the JAX worker does.
"""

import dataclasses
import json
import queue
import threading
import time
import types

import jax
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
from test_torch_train_nodes import checkpoint  # noqa: F401 — a fixture

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
    """The config without the port-only ``MLConfig`` fields (the worker's
    torch device and the devices it advertises for a planned mesh), each
    at its default."""
    d = dict(d, ml=dict(d["ml"]))
    assert d["ml"].pop("device", "absent") is None
    assert d["ml"].pop("mesh_devices", "absent") is None
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
_VERBS = {"fwd with a session": None, "load_stage with a mesh": 4,
          "load_stage with coworkers": None,
          "load_stage training a slice": None}


def _slice_stage(**kw):
    from test_torch_train_nodes import JCFG

    return {"worker_id": "w0", "layer_lo": 0, "layer_hi": JCFG.n_layers // 2,
            "first": True, "last": False, "holds_head": False,
            "mesh_axes": {}, "coworkers": [], **kw}


def _mesh_slice_fwd(pkg, ckpt):
    """A bare worker of ``pkg`` holding the first half of a tiny model
    over a ``{stage: 2}`` mesh: one FORWARD of two rows, no session."""
    from test_torch_train_nodes import JCFG, bare_worker, call

    w = bare_worker(pkg)
    call(w, "load_stage", stage=_slice_stage(mesh_axes={"stage": 2}),
         training=False, model={"name": "tiny", "config": JCFG.to_json(),
                                "ckpt": ckpt, "seed": 0})
    toks = np.array([[5, 9, 2, 77, 31], [1, 2, 3, 4, 0]], np.int32)
    _, body = call(w, "fwd", op="stage", tokens=toks)
    return np.asarray(body["out"])


def _session_ops(pkg, ckpt):
    """A bare worker of ``pkg`` holding the first half of a tiny model:
    a session prefill, one decode op, and the decode op's duplicate."""
    from test_torch_train_nodes import JCFG, bare_worker, call

    w = bare_worker(pkg)
    call(w, "load_stage", stage=_slice_stage(), training=False,
         model={"name": "tiny", "config": JCFG.to_json(), "ckpt": ckpt,
                "seed": 0})
    toks = np.array([[5, 9, 2, 77, 31], [1, 2, 3, 4, 0]], np.int32)
    mask = np.ones(toks.shape, bool)
    mask[1, 4] = False
    sess = dict(session="s1", cache_len=16)
    _, pre = call(w, "fwd", op="stage", tokens=toks, attn_mask=mask, seq=0,
                  **sess)
    _, dec = call(w, "fwd", op="stage", tokens=toks[:, :1], seq=1, **sess)
    _, dup = call(w, "fwd", op="stage", tokens=toks[:, 1:2], seq=1, **sess)
    length = w.jobs["ab12cd34"].sessions["s1"].length
    return pre, dec, dup, np.asarray(length).tolist()


def _slice_train_ops(pkg, ckpt):
    """Bare workers of ``pkg`` training each half of a tiny model: the
    first half's train FORWARD over tokens and its BACKWARD, the second
    half's (with the head) over a hidden state and its BACKWARD, which
    also answers the gradient of that input. Returns each half's
    (forward out, backward reply, accumulated gradient leaves)."""
    from test_torch_train_nodes import JCFG, JOB, bare_worker, call

    from tensorlink_tpu_torch.engine import optimizers as topt

    rng = np.random.default_rng(17)
    toks = rng.integers(0, JCFG.vocab_size, (2, 6)).astype(np.int32)
    hidden = rng.standard_normal((2, 6, JCFG.d_model)).astype(np.float32)
    half = JCFG.n_layers // 2
    out = []
    for stage, x in (
        (_slice_stage(), {"tokens": toks}),
        (_slice_stage(layer_lo=half, layer_hi=JCFG.n_layers, first=False,
                      last=True, holds_head=True), {"hidden": hidden}),
    ):
        w = bare_worker(pkg)
        call(w, "load_stage", stage=stage, training=True,
             model={"name": "tiny", "config": JCFG.to_json(), "ckpt": ckpt,
                    "seed": 0})
        _, fwd = call(w, "fwd", op="stage", train=True, tag="t0", **x)
        g = rng.standard_normal(np.asarray(fwd["out"]).shape)
        _, bwd = call(w, "bwd", op="stage", tag="t0",
                      grad=g.astype(np.float32))
        acc = w.jobs[JOB].grad_accum
        leaves = ([t.numpy() for t in topt.tree_leaves(acc)]
                  if pkg == "port" else
                  [np.asarray(a) for a in jax.tree.leaves(acc)])
        out.append((fwd, bwd, leaves))
    return out


@pytest.mark.parametrize("verb", list(_VERBS))
def test_unported_worker_verb_answers_with_its_roadmap_item(verb, checkpoint):
    """A session FORWARD on a layer-slice stage is ported: the port worker
    answers it as the JAX worker does (hidden states at 2e-5, cache
    lengths equal), and a duplicated seq is answered from the ledger
    without applying again. So is training a layer slice: each half's
    train FORWARD, its BACKWARD's gradient of the input (answered by the
    later half only) equal the JAX worker's at 2e-5, and each leaf of its
    accumulated parameter gradients within 2e-5 in its norm. A stage the port still refuses (a stage mesh
    axis, co-slice coworkers) answers with an error naming its ROADMAP
    item. A stage mesh axis is ported (ROADMAP queue 1 item 4.2): the
    slice loads over ``{stage: 2}`` and a whole-sequence FORWARD runs
    through the in-mesh GPipe, equal to the JAX worker's at 2e-5.
    Co-slice coworkers are ported (item 4.3): a merged stage without a
    mesh loads as the JAX worker's does, and one whose mesh spans the
    members refuses to load on a worker that joined no group, naming the
    settings (tests/test_torch_coslice_e2e.py drives a joined pair)."""
    if verb == "load_stage with coworkers":
        from test_torch_train_nodes import JCFG, bare_worker, call

        for pkg in ("port", "jax"):
            w = bare_worker(pkg)
            _, body = call(w, "load_stage", stage=_slice_stage(
                coworkers=["w1"]), training=True, model={
                    "name": "tiny", "config": JCFG.to_json(), "seed": 0})
            assert body["ok"] and body["n_layers"] == JCFG.n_layers // 2
        w = bare_worker("port")
        with pytest.raises(RuntimeError, match="coordinator_address"):
            call(w, "load_stage", stage=_slice_stage(
                coworkers=["w1"], mesh_axes={"tensor": 2}), training=True,
                model={"name": "tiny", "config": JCFG.to_json(), "seed": 0})
        return
    if verb == "load_stage with a mesh":
        ckpt, _ = checkpoint
        got, want = _mesh_slice_fwd("port", ckpt), _mesh_slice_fwd("jax",
                                                                   ckpt)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    if verb == "load_stage training a slice":
        ckpt, _ = checkpoint
        got = _slice_train_ops("port", ckpt)
        want = _slice_train_ops("jax", ckpt)
        for (gf, gb, gl), (wf, wb, wl) in zip(got, want):
            np.testing.assert_allclose(np.asarray(gf["out"]),
                                       np.asarray(wf["out"]), rtol=2e-5,
                                       atol=2e-5)
            assert ("grad" in gb) == ("grad" in wb)
            if "grad" in wb:
                np.testing.assert_allclose(np.asarray(gb["grad"]),
                                           np.asarray(wb["grad"]),
                                           rtol=2e-5, atol=2e-5)
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):  # each leaf in its norm
                assert a.shape == b.shape
                assert np.linalg.norm(a - b) <= 2e-5 * np.linalg.norm(b)
        assert "grad" not in got[0][1] and "grad" in got[1][1]
        return
    if _VERBS[verb] is None:
        ckpt, _ = checkpoint
        got = _session_ops("port", ckpt)
        want = _session_ops("jax", ckpt)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(np.asarray(a["out"]),
                                       np.asarray(b["out"]), rtol=2e-5,
                                       atol=2e-5)
        assert np.array_equal(np.asarray(got[2]["out"]),
                              np.asarray(got[1]["out"]))
        assert got[3] == want[3] == [6, 5]
        return
    from test_torch_train_nodes import JCFG

    from tensorlink_tpu_torch.ml.worker import DistributedWorker

    # a {data, fsdp, tensor} mesh is ported (tests/test_torch_mesh.py,
    # tests/test_torch_fsdp.py); its in-mesh stage axis still refuses
    # with item 4
    stage = {"load_stage with a mesh": _slice_stage(mesh_axes={"stage": 2}),
             "load_stage with coworkers": _slice_stage(coworkers=["w1"])}[verb]
    bridge = _Bridge([("load_stage", {
        "rid": "r1", "peer": "p1", "job_id": "j", "stage": stage,
        "training": False,
        "model": {"name": "tiny", "config": JCFG.to_json(), "seed": 0}})])
    node = types.SimpleNamespace(
        bridge=bridge, node_id="w0",
        config=tconfig.WorkerConfig(ml=tconfig.MLConfig(device="cpu")))
    DistributedWorker(node).run()
    [(kind, body)] = bridge.sent
    assert kind == "respond" and body["rid"] == "r1" and body["peer"] == "p1"
    err = body["body"]["error"]
    assert err.startswith("NotImplementedError")
    assert f"ROADMAP queue 1 item {_VERBS[verb]}" in err


def test_idle_session_row_leaves_no_nan_behind(checkpoint):
    """A session row that holds nothing attends to no key (NaN in both
    packages); the port worker zeroes what such a row wrote, so a request
    admitted into the row later — shorter than the op that left the NaN —
    gets the logits of a session that only ever held it."""
    from test_torch_train_nodes import JCFG, bare_worker, call

    ckpt, _ = checkpoint
    w = bare_worker("port")
    call(w, "load_stage", stage=_slice_stage(
        layer_hi=JCFG.n_layers, last=True, holds_head=True), training=False,
        model={"name": "tiny", "config": JCFG.to_json(), "ckpt": ckpt,
               "seed": 0})
    toks = np.array([[5, 9, 2, 77, 31], [0, 0, 0, 0, 0]], np.int32)
    mask = np.array([[True] * 5, [False] * 5])
    sess = dict(session="s1", cache_len=16)
    call(w, "fwd", op="stage", tokens=toks, attn_mask=mask, seq=0, **sess)
    late = np.array([[0, 0, 0], [9, 1, 2]], np.int32)
    _, got = call(w, "fwd", op="stage", tokens=late, seq=1, attn_mask=np.array(
        [[False] * 3, [True] * 3]), **sess)
    _, want = call(w, "fwd", op="stage", tokens=late[1:], session="s2",
                   cache_len=16, seq=0)
    got = np.asarray(got["out"])[1]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want["out"])[0], rtol=2e-5,
                               atol=2e-5)


# -- the fleet verbs (DRAIN, MIGRATE, HANDOFF, REPLICA_SET) ----------------
# tlint: disable=TL006(read-only test data)
_PROMPTS = [[7, 3, 100, 5], [9, 1, 2, 30, 7], [5, 5, 8]]
_BUDGET = 40
JOB_FLEET = "cd34ef56"


class _NetBridge:
    """One bare worker's bridge inside :class:`_Net`: replies recorded, a
    ``tensor_request`` to a peer runs the peer's handler in process and
    returns its reply, and ``connect`` resolves an address to a peer."""

    def __init__(self, net, idx: int):
        self.net, self.idx = net, idx
        self.q = types.SimpleNamespace(work=queue.Queue())
        self.sent: list = []

    def request(self, verb, payload=None, timeout=None):
        self.sent.append((verb, payload))
        if verb == "connect":
            return f"w{int(payload['port']) - 7000}"
        if verb == "tensor_request":
            return self.net.call(int(payload["peer"][1:]), payload["tag"],
                                 payload["body"], peer=f"w{self.idx}")
        return None

    notify = request


class _Net:
    """Bare workers of one package wired together in process: ``wN``
    listens on 127.0.0.1:700N, and a request to a peer runs its handler
    synchronously, as the network process would relay it."""

    def __init__(self, pkg: str, roles=("mixed", "mixed")):
        if pkg == "port":
            from tensorlink_tpu_torch.core import config as C
            from tensorlink_tpu_torch.ml.worker import DistributedWorker

            mls = [C.MLConfig(device="cpu", worker_role=r) for r in roles]
        else:
            from tensorlink_tpu.core import config as C
            from tensorlink_tpu.ml.worker import DistributedWorker

            mls = [C.MLConfig(worker_role=r) for r in roles]
        self.workers = []
        self._rid = 0
        self._lock = threading.Lock()
        for i, ml in enumerate(mls):
            node = types.SimpleNamespace(
                bridge=_NetBridge(self, i), node_id=f"w{i}",
                config=C.WorkerConfig(ml=ml), crash=lambda: None)
            self.workers.append(DistributedWorker(node))

    @staticmethod
    def dest(i: int) -> dict:
        return {"id": f"w{i}", "addr": ["127.0.0.1", 7000 + i]}

    def submit(self, i: int, tag: str, body: dict,
               peer: str = "client") -> str:
        """Run one work item on worker ``i``; returns its rid."""
        with self._lock:
            self._rid += 1
            rid = f"rid{self._rid}"
        kind = "load_stage" if tag == "module" else tag
        self.workers[i]._handle(kind, {**body, "rid": rid, "peer": peer})
        return rid

    def reply(self, i: int, rid: str):
        """The reply worker ``i`` sent for ``rid`` (None before it has)."""
        for verb, p in list(self.workers[i].bridge.sent):
            if verb == "respond" and p["rid"] == rid:
                return p["body"]
        return None

    def call(self, i: int, tag: str, body: dict, peer: str = "client"):
        """One work item and the reply it sent at once (None for a verb
        that sends none)."""
        return self.reply(i, self.submit(i, tag, body, peer))

    def step(self, i: int, job: str, n: int = 1) -> None:
        for _ in range(n):
            self.workers[i]._handle("cont_continue", {"job_id": job})


def _serving_job(net, i, ckpt, job=JOB_FLEET):
    stage = {"worker_id": f"w{i}", "layer_lo": 0, "layer_hi": 4,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": {}, "coworkers": []}
    return net.call(i, "module", {
        "job_id": job, "stage": stage, "training": False,
        "model": {"name": "tiny", "config": _tiny_config_json(),
                  "ckpt": ckpt, "seed": 0}})


def _tiny_config_json():
    from test_torch_train_nodes import JCFG

    return JCFG.to_json()


def _gen(net, i, prompt, n, job=JOB_FLEET, **kw) -> str:
    """Admit one continuous greedy request on worker ``i``; its rid."""
    return net.submit(i, "gen", {"job_id": job, "prompts": [prompt],
                                 "max_new_tokens": n, "continuous": True,
                                 "seed": 0, **kw})


def _wait_reply(net, i, rid, job=JOB_FLEET):
    """Step worker ``i``'s slot engine until it has answered ``rid``."""
    for _ in range(200):
        r = net.reply(i, rid)
        if r is not None:
            return r
        net.step(i, job)
    raise AssertionError(f"no reply for {rid}")


def _redirect(reply: dict) -> dict:
    """A migration redirect without what differs run to run: the random
    ticket id (only whether there is one) and the engine snapshot."""
    mig = dict(reply["migrated"])
    mig["mig"] = mig["mig"] is not None
    return mig


def _resume(net, prompt, n, mig: dict, job=JOB_FLEET):
    """The client's resume at the redirect's destination: prompt +
    emitted, the rest of the budget, the staged ticket when pages
    shipped. Returns the whole stream."""
    so_far = list(mig["tokens_so_far"])
    dst = int(mig["worker"][1:])
    body = {"start_step": len(so_far)}
    if mig.get("mig"):
        body["adopt"] = mig["mig"]
    rid = _gen(net, dst, prompt + so_far, n - len(so_far), job=job, **body)
    return so_far + list(_wait_reply(net, dst, rid, job)["sequences"][0])


def _fleet_verb(pkg: str, verb: str, ckpt: str) -> dict:
    """Drive one fleet verb between bare workers of ``pkg``; returns what
    it answered and the streams it moved."""
    if verb == "handoff":
        net = _Net(pkg, roles=("prefill", "decode"))
    else:
        net = _Net(pkg)
    assert _serving_job(net, 0, ckpt)["ok"]
    out: dict = {}
    if verb == "replica.set":
        # no reply: the worker keeps the siblings a destination-less
        # DRAIN falls back to (itself and address-less entries dropped)
        out["push"] = net.call(0, "replica.set", {
            "job_id": JOB_FLEET,
            "peers": [net.dest(1), {"id": "w0", "addr": ["h", 1]},
                      {"id": "w7"}]})
        out["siblings"] = net.workers[0]._replica_sets
    if verb == "handoff":
        out["push"] = net.call(0, "handoff", {"job_id": JOB_FLEET,
                                              "pool": [net.dest(1)]})
        deadline = time.monotonic() + 60
        while (JOB_FLEET, "w1") not in net.workers[0]._handoff_dest_ready:
            assert time.monotonic() < deadline, "pool member never warmed"
            time.sleep(0.05)
        out["pool"] = net.workers[0]._handoff_pool_for(JOB_FLEET)
    if verb == "mig":
        # the destination side before it hosts the job, then after
        out["probe_cold"] = net.call(1, "mig", {
            "op": "probe", "job_id": JOB_FLEET,
            "chain": np.zeros(0, np.int32), "limit": 0})
        assert _serving_job(net, 1, ckpt)["ok"]
    rids = [_gen(net, 0, p, _BUDGET) for p in _PROMPTS]
    net.step(0, JOB_FLEET, 3)
    if verb == "mig":
        # one decoding slot shipped by hand over the MIGRATE ops
        w0 = net.workers[0]
        rt = w0.jobs[JOB_FLEET]
        slot = next(s for k, s, _r in rt.cont.live_manifest() if k == "decode")
        rt.cont.freeze_slot(slot)
        chain, limit = rt.cont.migration_chain(slot)
        out["probe"] = net.call(1, "mig", {
            "op": "probe", "job_id": JOB_FLEET,
            "chain": np.asarray(chain, np.int32), "limit": int(limit)})
        blob = rt.cont.export_slot(slot, n_skip=0)
        out["put"] = net.call(1, "mig", {"op": "put", "job_id": JOB_FLEET,
                                         "mig": "t1", "blob": blob})
        out["put_again"] = net.call(1, "mig", {
            "op": "put", "job_id": JOB_FLEET, "mig": "t1", "blob": blob})
        out["staged"] = list(net.workers[1].jobs[JOB_FLEET]
                             .cont.staged_migrations())
        out["pull"] = net.call(1, "mig", {
            "op": "pull", "job_id": JOB_FLEET,
            "chain": np.asarray(_PROMPTS[0], np.int32), "limit": 4})
        out["expire"] = net.call(1, "mig", {"op": "expire",
                                            "job_id": JOB_FLEET})
        rt.cont.abort_migration(slot)
        net.workers[1].draining = net.dest(0)
        out["probe_fenced"] = net.call(1, "mig", {
            "op": "probe", "job_id": JOB_FLEET,
            "chain": np.zeros(0, np.int32), "limit": 0})
        return out
    if verb in ("drain", "replica.set"):
        body = {} if verb == "replica.set" else {"dest": net.dest(1)}
        out["refused_self"] = net.call(0, "drain", {"dest": net.dest(0)}) \
            if verb == "drain" else None
        out["summary"] = net.call(0, "drain", body)
        out["capacity_fenced"] = [
            p for v, p in net.workers[0].bridge.sent if v == "set_capacity"]
        # an admission after the drain is redirected at once
        out["fenced"] = _redirect(net.reply(0, _gen(net, 0, [1, 2, 3], 8)))
    moved = [_wait_reply(net, 0, rid) for rid in rids]
    out["redirects"] = [_redirect(r) for r in moved]
    out["streams"] = [
        _resume(net, p, _BUDGET, r["migrated"])
        for p, r in zip(_PROMPTS, moved)
    ]
    for w in net.workers:
        for rt in w.jobs.values():
            if rt.cont is not None:
                rt.cont.check_page_conservation()
                out.setdefault("in_transit", []).append(
                    rt.cont.serving_snapshot()["pages_in_transit"])
    return out


def _unmoved(ckpt) -> list:
    """The streams of :data:`_PROMPTS` on one port worker, never moved."""
    net = _Net("port")
    assert _serving_job(net, 0, ckpt)["ok"]
    rids = [_gen(net, 0, p, _BUDGET) for p in _PROMPTS]
    return [list(_wait_reply(net, 0, rid)["sequences"][0]) for rid in rids]


@pytest.mark.parametrize("verb", ["drain", "mig", "handoff", "replica.set"])
def test_fleet_worker_verb_replies_equal_jax(verb, checkpoint):
    """Each fleet verb between two bare workers answers as the JAX
    worker's does, and every stream it moves resumes at the destination
    equal to its unmoved run (and to the JAX worker's)."""
    ckpt, _ = checkpoint
    port = _fleet_verb("port", verb, ckpt)
    jx = _fleet_verb("jax", verb, ckpt)
    assert port == jx
    if verb == "mig":
        assert port["probe_cold"] == {"ok": True, "loaded": False}
        assert port["put"] == port["put_again"] == {"ok": True}
        assert port["staged"] == ["t1"] and port["expire"]["expired"] == 1
        assert port["probe_fenced"]["ok"] is False
        return
    assert port["streams"] == _unmoved(ckpt)
    assert set(port["in_transit"]) == {0}
    if verb == "handoff":
        assert all(r["handoff"] and r["mig"] for r in port["redirects"])
    else:
        s = port["summary"]
        assert s["ok"] and s["migrated"] >= 1
        assert s["migrated"] + s["fell_back"] == len(_PROMPTS)


def _reattach_run(pkg: str, ckpt: str) -> dict:
    """Two journaled streams on one bare worker lose their client: a
    re-attach rebinds the live one (backlog past the new client's mark,
    then the rest) and replays the finished one from the orphan ledger."""
    net = _Net(pkg)
    assert _serving_job(net, 0, ckpt)["ok"]
    live = _gen(net, 0, _PROMPTS[0], _BUDGET, jrid="j-live", stream="s1")
    done = _gen(net, 0, _PROMPTS[1], 8, jrid="j-done")
    net.step(0, JOB_FLEET, 2)
    out = {"done": net.reply(0, done)["sequences"]}
    re_done = _gen(net, 0, _PROMPTS[1], 8, jrid="j-done", reattach="j-done")
    re_live = _gen(net, 0, _PROMPTS[0], _BUDGET, jrid="j-live",
                   reattach="j-live", hwm=5, stream="s2")
    out["replayed"] = net.reply(0, re_done)
    out["rebound"] = _wait_reply(net, 0, re_live)
    out["old_client"] = net.reply(0, live)  # the dead client hears nothing
    for k in ("replayed", "rebound"):
        out[k] = {k2: v for k2, v in out[k].items()
                  if k2 not in ("serving", "trace")}
    out["s2"] = [t for v, p in net.workers[0].bridge.sent
                 if v == "send_token" and p["stream"] == "s2"
                 for _row, t in p["tokens"]]
    # a miss (the ledger entry was drained) admits afresh
    again = _gen(net, 0, _PROMPTS[1], 8, jrid="j-done", reattach="j-done")
    out["again"] = _wait_reply(net, 0, again)["sequences"]
    return out


def test_reattach_rebinds_live_and_replays_finished_equal_jax(checkpoint):
    ckpt, _ = checkpoint
    port = _reattach_run("port", ckpt)
    assert port == _reattach_run("jax", ckpt)
    full = _unmoved(ckpt)[0]
    assert port["rebound"]["reattached"] and port["rebound"]["resume_base"] == 0
    assert port["rebound"]["sequences"] == [full]
    assert port["s2"] == full[5:]
    assert port["old_client"] is None
    assert port["replayed"]["reattached"]
    assert port["replayed"]["sequences"] == port["done"] == port["again"]


def _verb_run(pkg: str, verb: str, ckpt: str, tmp) -> tuple:
    """Load one tiny training job into a bare worker of ``pkg``, drive what
    ``verb`` needs first, then the verb itself. Returns the verb's
    (tag, reply) and the worker."""
    from test_torch_train_nodes import (
        bare_worker,
        call,
        load_training_job,
        train_step,
    )

    w = bare_worker(pkg)
    load_training_job(w, ckpt)
    toks = np.random.default_rng(3).integers(0, 128, (2, 12)).astype(np.int32)
    if verb == "fwd":
        return call(w, "fwd", op="stage", tokens=toks), w
    if verb == "bwd":
        from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

        _, out = call(w, "fwd", op="stage", train=True, tag="t0", tokens=toks)
        _, dl, _ = _ce_sum_and_grad(torch.as_tensor(np.array(out["out"])),
                                    toks, np.ones(toks.shape, bool))
        return call(w, "bwd", op="stage", tag="t0", grad=dl.numpy()), w
    if verb in ("opt", "proof.req", "ckpt"):
        assert call(w, "opt", op="init",
                    spec={"name": "adamw", "lr": 1e-3, "grad_clip": None}) \
            == (tproto.OPTIMIZER_RESP, {"ok": True, "op": "init"})
    if verb == "opt":
        from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

        _, out = call(w, "fwd", op="stage", train=True, tag="t0", tokens=toks)
        _, dl, n = _ce_sum_and_grad(torch.as_tensor(np.array(out["out"])),
                                    toks, np.ones(toks.shape, bool))
        call(w, "bwd", op="stage", tag="t0", grad=dl.numpy())
        return call(w, "opt", op="step", scale=1.0 / float(n)), w
    if verb == "proof.req":
        train_step(w, toks, "t0")
        train_step(w, toks[::-1].copy(), "t1")
        return call(w, "proof.req"), w
    if verb == "ckpt":
        train_step(w, toks, "t0")
        return call(w, "ckpt", op="save", dir=str(tmp / pkg)), w
    if verb == "params.req":
        return call(w, "params.req"), w
    if verb == "train.mode":
        return call(w, "train.mode", training=True), w
    raise AssertionError(verb)


_TRAINING_VERBS = ("fwd", "bwd", "opt", "proof.req", "ckpt", "params.req",
                   "train.mode")


@pytest.mark.parametrize("verb", _TRAINING_VERBS)
def test_training_worker_verb_answers_as_the_jax_worker(verb, checkpoint,
                                                        tmp_path):
    """A bare worker of each package loads the same tiny training job (the
    JAX exporter's checkpoint); the port's reply to each training verb is
    the JAX worker's: the same tag and keys, arrays within float32
    rounding."""
    ckpt, _ = checkpoint
    (ttag, tbody), tw = _verb_run("port", verb, ckpt, tmp_path)
    (jtag, jbody), jw = _verb_run("jax", verb, ckpt, tmp_path)
    assert ttag == jtag and set(tbody) == set(jbody), (tbody, jbody)
    if verb == "fwd":
        assert tbody["is_logits"] is jbody["is_logits"] is True
        np.testing.assert_allclose(tbody["out"], np.asarray(jbody["out"]),
                                   rtol=2e-5, atol=2e-5)
    elif verb in ("bwd", "train.mode"):
        assert tbody == jbody
        if verb == "bwd":  # and the accumulated gradients agree
            from test_torch_train_nodes import call

            (_, tn), (_, jn) = (call(w, "opt", op="grad_norm")
                                for w in (tw, jw))
            np.testing.assert_allclose(tn["grad_norm"], jn["grad_norm"],
                                       rtol=1e-5)
    elif verb == "opt":
        assert tbody["ok"] and tbody["op"] == jbody["op"] == "step"
        np.testing.assert_allclose(tbody["grad_norm"], jbody["grad_norm"],
                                   rtol=1e-5)
    elif verb == "proof.req":
        from tensorlink_tpu.platform.proofs import verify_proof_log as jverify
        from tensorlink_tpu_torch.platform.proofs import verify_proof_log

        assert tbody["total_steps"] == jbody["total_steps"] == 2
        for te, je in zip(tbody["log"], jbody["log"], strict=True):
            assert te["step"] == je["step"]
            np.testing.assert_allclose(te["grad_norm"], je["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(te["sketch"], je["sketch"],
                                       rtol=1e-4, atol=1e-5)
        for log in (tbody["log"], jbody["log"]):
            assert verify_proof_log(log)[0] and jverify(log)[0]
    elif verb == "ckpt":
        assert tbody["ok"] and jbody["ok"]
        assert tbody["path"].split("/")[-1] == jbody["path"].split("/")[-1]
        # each restores what it wrote, optimizer state included
        from test_torch_train_nodes import call

        restored = [call(w, "ckpt", op="restore", dir=str(tmp_path / pkg))
                    for w, pkg in ((tw, "port"), (jw, "jax"))]
        assert restored[0] == restored[1]
        assert restored[0][1] == {"ok": True, "restored_opt": True,
                                  "opt_in_checkpoint": True}
    elif verb == "params.req":
        jflat = jax.tree_util.tree_leaves_with_path(jbody["params"])
        for path, leaf in jflat:
            node = tbody["params"]
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
    if verb == "train.mode":
        # an int8-weight serving job refuses to train, in both packages
        # (at widths whose matmul weights reach quantize_params' minimum)
        from test_torch_train_nodes import JCFG, call

        qcfg = JCFG.with_(d_model=128, d_ff=256, head_dim=32, n_layers=2)
        stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": 2,
                 "first": True, "last": True, "holds_head": True,
                 "mesh_axes": {}, "coworkers": []}
        for w in (tw, jw):
            call(w, "load_stage", stage=stage, training=False,
                 model={"name": "tiny-q", "config": qcfg.to_json(),
                        "seed": 0, "quant": "int8"})
            with pytest.raises(ValueError, match="int8-quantized"):
                call(w, "train.mode", training=True)

"""Job repair over the port's node stack: a worker dies mid-job and the
validator recruits a replacement (``DistributedModel._repair``, a pushed
``JOB_UPDATE``, or a second validator's adopted job record), on port
clusters of tiny float32 llamas whose weights the JAX exporter wrote.

The scenarios are the JAX package's (tests/test_recovery_e2e.py :67, :97,
:124; the worker-crash cases of tests/test_chaos_e2e.py :122, :165, :289,
:672, :732, :965):

- a forward after its worker died repairs onto the spare: the same
  logits as before, and the JAX forward's within 2e-5;
- a stage worker of a two-stage job killed mid-decode: the session
  re-establishes on the spare and the stream equals the fault-free one;
- a training worker killed on its 4th optimizer step with
  ``ckpt_every_steps=2``: the job rolls back to the step-2 checkpoint and
  every loss equals the JAX compiled step's on the batches the job
  really trained (rtol 1e-4, atol 1e-5, as tests/test_torch_train_nodes.py);
- continuous streams whose worker crashed mid-chunk, or whose drain lost
  its destination, its source or a prefill worker mid-handoff, finish
  equal to the fault-free slot engine's streams.

The fault-free decode references are the JAX package's engines on the
checkpoint's weights; the slot engine's is the port's, held equal to the
JAX one's. Each test starts its own cluster, and every request has a
timeout."""

import dataclasses
import threading
import time
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine.loader import export_hf as j_export_hf
from tensorlink_tpu.engine.loader import load_params as j_load_params
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax
from tensorlink_tpu_torch.core.config import (
    MLConfig,
    UserConfig,
    ValidatorConfig,
    WorkerConfig,
)

pytestmark = pytest.mark.e2e
torch.set_num_threads(1)

JCFG = JModelConfig(
    family="llama", vocab_size=512, d_model=128, n_layers=6, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, max_seq_len=64, dtype=jnp.float32,
)
# the training and single-worker model (tests/test_recovery_e2e.py)
JSMALL = JModelConfig(
    family="llama", vocab_size=128, d_model=48, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=96, max_seq_len=64, dtype=jnp.float32,
)
TIMEOUT = 60.0  # every cluster request
CONT_PROMPTS = ([7, 3, 200], [9, 1, 2, 300])
CONT_TOKENS = 56  # outlives a drain


def _export(jcfg, seed, path):
    jp = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    return str(j_export_hf(jcfg, jp, path))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _export(JCFG, 11, tmp_path_factory.mktemp("ckpt") / "m")


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    return _export(JSMALL, 13, tmp_path_factory.mktemp("small") / "m")


@lru_cache(maxsize=None)
def _jax_params(path: str, small: bool):
    return j_load_params(path, JSMALL if small else JCFG)[1]


def _jax_greedy(path, prompt, n):
    from tensorlink_tpu.engine.generate import GenerationEngine

    eng = GenerationEngine(JCFG, _jax_params(path, False), max_seq_len=64)
    return eng.generate_compiled([prompt], max_new_tokens=n).sequences[0]


def _slot_greedy(pkg, params, prompts, n):
    """Each prompt alone on a slot engine with the worker's default
    knobs (int8 pages, speculation on), in ``pkg``."""
    if pkg == "port":
        from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
        from tensorlink_tpu_torch.engine.generate import GenerationEngine

        cfg = config_from_jax(dataclasses.asdict(JCFG))
        ml = MLConfig(device="cpu")
        gen = GenerationEngine(cfg, params, max_seq_len=64, device="cpu",
                               seq_buckets=ml.seq_buckets,
                               batch_buckets=ml.batch_buckets)
    else:
        from tensorlink_tpu.core.config import MLConfig as JMLConfig
        from tensorlink_tpu.engine.continuous import ContinuousEngine
        from tensorlink_tpu.engine.generate import GenerationEngine

        ml = JMLConfig()
        gen = GenerationEngine(JCFG, params, max_seq_len=64,
                               seq_buckets=ml.seq_buckets,
                               batch_buckets=ml.batch_buckets)
    out = []
    for ids in prompts:
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
def cont_reference(ckpt):
    """The fault-free continuous streams of CONT_PROMPTS: the port's slot
    engine on the checkpoint's weights, held equal to the JAX one's."""
    from tensorlink_tpu_torch.engine.loader import load_params

    cfg = config_from_jax(dataclasses.asdict(JCFG))
    _, tp = load_params(ckpt, cfg, device="cpu")
    port = _slot_greedy("port", tp, CONT_PROMPTS, CONT_TOKENS)
    assert port == _slot_greedy("jax", _jax_params(ckpt, False),
                                CONT_PROMPTS, CONT_TOKENS)
    return port


# -- clusters ----------------------------------------------------------------
def _common(tmp):
    return dict(local_test=True, key_dir=str(tmp / "keys"),
                log_dir=str(tmp / "logs"), env_file=str(tmp / ".env"))


def _validator(tmp, **kw):
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode

    return ValidatorNode(ValidatorConfig(
        endpoint=False, monitor_interval=0.5, keeper_interval=1.0,
        proposal_interval=0.0, ml=MLConfig(device="cpu"), **_common(tmp),
        **kw)).start()


def _cluster(tmp, *, caps, faults=None, wml=None):
    """A port validator, one worker per capacity and a user on
    127.0.0.1; the capacities pin the planner's choice (it ranks by
    capacity), and a worker of 1 MB is too small to be planned."""
    from tensorlink_tpu_torch.nodes.runners import UserNode, WorkerNode

    nodes = [_validator(tmp)]
    try:
        seeds = [["127.0.0.1", nodes[0].port]]
        for i in range(len(caps)):
            nodes.append(WorkerNode(WorkerConfig(
                seed_validators=seeds, duplicate=str(i) if i else "",
                faults=(faults or {}).get(i, {}),
                ml=(wml or {}).get(i) or MLConfig(device="cpu"),
                **_common(tmp))).start())
        nodes.append(UserNode(UserConfig(seed_validators=seeds,
                                         **_common(tmp))).start())
        _wait(lambda: len(nodes[0].status()["peers"]) >= len(caps) + 1,
              "peers")
        for w, cap in zip(nodes[1:-1], caps):
            w.send_request("set_capacity", {"hbm_bytes": cap, "n_devices": 1})
    except BaseException:
        _stop(nodes)
        raise
    return nodes[0], nodes[1:-1], nodes[-1]


def _stop(nodes):
    """Stop every node at once (a crashed worker's network process takes
    its full join timeout)."""
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


def _wait(pred, what, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _model(user, path, small=False, **kw):
    from tensorlink_tpu_torch.ml.module import DistributedModel

    cfg = config_from_jax(dataclasses.asdict(JSMALL if small else JCFG))
    kw.setdefault("request_timeout", TIMEOUT)
    return DistributedModel(cfg, node=user, ckpt=path, seq_len=64, batch=1,
                            device="cpu", **kw)


def _crash(site, nth, seed=5):
    return {"seed": seed, "rules": [{"site": site, "op": "crash",
                                     "nth": nth}]}


# -- repair of a stateless job (tests/test_recovery_e2e.py) -------------------
TOKS = np.array([[7, 21, 3, 99]], np.int32)


def _jax_logits(path):
    from tensorlink_tpu.models.transformer import forward

    return np.asarray(forward(_jax_params(path, True), jnp.asarray(TOKS),
                              JSMALL)[0])


@pytest.mark.parametrize("how", ["pull", "push"])
def test_worker_replacement_on_failure(tmp_path, small_ckpt, how):
    """The hosting worker stops mid-job. ``pull``: the next forward's dead
    connection asks the validator for a replacement (JOB_REPAIR) and
    retries there. ``push``: the validator's monitor notices on its own
    and the user applies its JOB_UPDATE (``poll_job_updates``). Either
    way the logits equal the pre-crash ones and the JAX forward's."""
    v, (w1, w2), user = _cluster(tmp_path, caps=(8e9, 4e9))
    try:
        model = _model(user, small_ckpt, small=True)
        assert model.plan.stages[0].worker_id == w1.node_id
        before = model(TOKS).numpy()
        w1.stop()
        if how == "push":
            applied = 0
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not applied:
                applied = model.poll_job_updates()
                time.sleep(0.5)
            assert applied == 1
        else:
            time.sleep(0.5)
        after = model(TOKS).numpy()
        assert model.plan.stages[0].worker_id == w2.node_id
        np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(after, _jax_logits(small_ckpt), rtol=2e-5,
                                   atol=2e-5)
        model.shutdown()
    finally:
        _stop([user, w1, w2, v])


def test_validator_failover_repair(tmp_path, small_ckpt):
    """The validator that created the job dies with its worker; a second
    validator adopts the job from the replicated DHT record and serves
    the user's JOB_REPAIR."""
    from tensorlink_tpu_torch.nodes.runners import UserNode, WorkerNode

    v1 = _validator(tmp_path)
    v2 = _validator(tmp_path, duplicate="1",
                    seed_validators=[["127.0.0.1", v1.port]])
    seeds = [["127.0.0.1", v1.port]]
    w1 = WorkerNode(WorkerConfig(seed_validators=seeds,
                                 ml=MLConfig(device="cpu"),
                                 **_common(tmp_path))).start()
    w2 = WorkerNode(WorkerConfig(seed_validators=seeds, duplicate="1",
                                 ml=MLConfig(device="cpu"),
                                 **_common(tmp_path))).start()
    user = UserNode(UserConfig(seed_validators=seeds,
                               **_common(tmp_path))).start()
    try:
        _wait(lambda: len(user.send_request("validators")) >= 2 and sum(
            p["role"] == "worker" for p in v2.status()["peers"].values()
        ) >= 2, "the second validator")
        w1.send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        w2.send_request("set_capacity", {"hbm_bytes": 4e9, "n_devices": 1})
        model = _model(user, small_ckpt, small=True)
        assert model.plan.stages[0].worker_id == w1.node_id
        before = model(TOKS).numpy()
        _wait(lambda: v2.send_request(
            "dht_get", {"key": f"job:{model.job_id}"}), "the job record")
        _stop([v1, w1])  # the creating validator dies, with the worker
        time.sleep(0.5)
        after = model(TOKS).numpy()  # JOB_REPAIR lands on v2
        assert model.plan.stages[0].worker_id == w2.node_id
        np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(after, _jax_logits(small_ckpt), rtol=2e-5,
                                   atol=2e-5)
        model.shutdown()
    finally:
        _stop([user, w1, w2, v2, v1])


# -- worker crashes (tests/test_chaos_e2e.py) --------------------------------
def test_worker_crash_mid_decode_resumes_bit_identical(tmp_path, ckpt):
    """Stage 0's worker of a two-stage job dies at its 4th session op: the
    session re-establishes on the spare by re-prefilling prompt + emitted
    tokens, and the streamed tokens equal the fault-free run's."""
    v, ws, user = _cluster(
        tmp_path, caps=(3_000_000.0, 2_900_000.0, 1_000_000.0),
        faults={0: _crash("worker.session_step", 4, seed=7)})
    try:
        model = _model(user, ckpt)
        assert model.plan.n_stages == 2, model.plan
        assert model.plan.stages[0].worker_id == ws[0].node_id
        ws[2].send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        prompt, streamed = [7, 3, 200], []
        seqs = model.generate([prompt], max_new_tokens=10,
                              stream_cb=lambda toks: streamed.extend(
                                  t for t in toks if t is not None))
        assert model.plan.stages[0].worker_id == ws[2].node_id
        want = _jax_greedy(ckpt, prompt, 10)
        assert seqs[0] == want and streamed == want
        model.shutdown()
    finally:
        _stop([user, *ws, v])


def _jax_losses(params, batches, lr):
    from tensorlink_tpu.engine import training as jtrain

    opt = jtrain.make_optimizer("adamw", lr=lr, grad_clip=1.0)
    ts = jtrain.make_train_step(JSMALL, opt, n_micro=1, donate=False)
    state, out = ts.init_state(params), []
    for toks in batches:
        params, state, m = ts.step_fn(params, state,
                                      {"tokens": toks, "loss_mask": None})
        out.append(float(m["loss"]))
    return out


def test_worker_crash_mid_training_resumes_from_auto_ckpt(tmp_path,
                                                          small_ckpt):
    """The training worker dies on its 4th optimizer step. With
    ``ckpt_every_steps=2`` the job checkpointed after step 2: the repair
    restores params and optimizer state there and rolls the step counter
    back (step 3's update is lost, the at-most-N contract), and the
    model trains on. Every loss equals the JAX compiled step's over the
    batches the job really trained: 1, 2, 3, then 1, 2, 4, 5, 6."""
    import json

    rng = np.random.default_rng(0)
    batches = [rng.integers(1, JSMALL.vocab_size, (2, 16)).astype(np.int32)
               for _ in range(6)]
    v, ws, user = _cluster(tmp_path, caps=(8e9, 4e9),
                           faults={0: _crash("worker.train_step", 4, seed=3)})
    try:
        model = _model(user, small_ckpt, small=True, training=True,
                       ckpt_every_steps=2, ckpt_dir=str(tmp_path / "ck"))
        first = model.plan.stages[0].worker_id
        model.init_optimizer("adamw", lr=5e-3)
        losses = [model.train_step(b)["loss"] for b in batches]
        replaced = model.plan.stages[0].worker_id != first
        step = model._step
        model.shutdown()
    finally:
        _stop([user, *ws, v])
    assert replaced and step == 5, step
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["step"] == 4
    jp = _jax_params(small_ckpt, True)
    first3 = _jax_losses(jp, batches[:3], 5e-3)
    after = _jax_losses(jp, batches[:2] + batches[3:], 5e-3)
    np.testing.assert_allclose(losses[:3], first3, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses[3:], after[2:], rtol=1e-4, atol=1e-5)


def _start_streams(model, n_toks=CONT_TOKENS):
    """One streamed continuous generate per CONT_PROMPTS entry, each on a
    thread: (threads, streams, results, errors)."""
    k = len(CONT_PROMPTS)
    streams = [[] for _ in range(k)]
    results, errors = [None] * k, [None] * k

    def go(i):
        try:
            results[i] = model.generate(
                [CONT_PROMPTS[i]], max_new_tokens=n_toks, continuous=True,
                priority=("interactive", "batch")[i],
                stream_cb=lambda toks, i=i: streams[i].extend(
                    t for t in toks if t is not None))[0]
        except BaseException as e:  # noqa: BLE001 — asserted by the caller
            errors[i] = e

    threads = [threading.Thread(target=go, args=(i,), daemon=True)
               for i in range(k)]
    for t in threads:
        t.start()
        time.sleep(0.05)
    return threads, streams, results, errors


def _finish(threads, streams, results, errors, want):
    for t in threads:
        t.join(3 * TIMEOUT)
    assert errors == [None] * len(want), errors
    assert results == want
    assert streams == want


def test_worker_crash_mid_continuous_batch_recovers_all_sessions(
        tmp_path, ckpt, cont_reference):
    """The worker dies mid-chunk (``worker.cont_step``) with two streams
    in its slot batch: each re-submits prompt + delivered tokens on the
    repaired worker and both finish equal to the fault-free streams."""
    v, ws, user = _cluster(tmp_path, caps=(8e9, 4e9),
                           faults={0: _crash("worker.cont_step", 2)})
    try:
        model = _model(user, ckpt)
        assert model.plan.stages[0].worker_id == ws[0].node_id
        _finish(*_start_streams(model), cont_reference)
        assert model.plan.stages[0].worker_id == ws[1].node_id
        model.shutdown()
    finally:
        _stop([user, *ws, v])


@pytest.mark.parametrize("side", ["destination", "source"])
def test_kill_mid_migration_streams_recover(tmp_path, ckpt, cont_reference,
                                            side):
    """A drain loses one end mid-transfer. ``destination``: it dies on the
    first MIGRATE staging; the source falls back to redirecting, the
    redirect target is dead, and the clients fall to validator repair
    onto the spare. ``source``: it dies mid-transfer, before any
    redirect; the streams recover as from a crash. Both streams finish
    equal to the fault-free ones either way."""
    if side == "destination":
        caps, faults = (8e9, 4e9, 1_000_000.0), {
            1: _crash("migrate.import", 1)}
    else:
        caps, faults = (8e9, 4e9), {0: _crash("migrate.wire", 1, seed=3)}
    v, ws, user = _cluster(tmp_path, caps=caps, faults=faults)
    try:
        model = _model(user, ckpt)
        assert model.plan.stages[0].worker_id == ws[0].node_id
        if side == "destination":
            ws[2].send_request("set_capacity",
                               {"hbm_bytes": 8e9, "n_devices": 1})
        threads, streams, results, errors = _start_streams(model)
        _wait(lambda: all(len(s) >= 2 for s in streams), "decoding streams")
        try:
            summary = v.send_request(
                "drain_worker",
                {"worker": ws[0].node_id, "dest": ws[1].node_id},
                timeout=TIMEOUT)
        except Exception:  # noqa: BLE001 — a dead source sends no summary
            summary = None
        _finish(threads, streams, results, errors, cont_reference)
        if side == "destination":
            assert summary["ok"] and summary["migrated"] == 0, summary
            assert summary["fell_back"] >= 1, summary
            assert model.plan.stages[0].worker_id == ws[2].node_id
        else:
            assert model.plan.stages[0].worker_id != ws[0].node_id
        model.shutdown()
    finally:
        _stop([user, *ws, v])


def test_kill_prefill_worker_mid_handoff_streams_recover(tmp_path, ckpt):
    """The prefill-role worker dies on its second page ship, after one
    stream was handed to the decode-role worker: that stream decodes on
    untouched, the stranded one falls to validator repair and re-prefills
    on the spare, and both finish equal to the fault-free streams; page
    conservation holds in every snapshot a survivor reported."""
    prompts = ([7, 3, 200, 5, 9, 2, 8, 4], [9, 1, 2, 300, 7, 7])
    v, ws, user = _cluster(
        tmp_path, caps=(8e9, 4e9, 1_000_000.0),
        wml={0: MLConfig(device="cpu", worker_role="prefill"),
             1: MLConfig(device="cpu", worker_role="decode")},
        faults={0: _crash("migrate.wire", 2)})
    try:
        model = _model(user, ckpt)
        assert model.plan.stages[0].worker_id == ws[0].node_id
        ws[2].send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        # the first stream's handoff finds its destination warm: until
        # the warm-up thread's MODULE ship lands, a handoff resumes locally
        # and the crash, planted on the second ship, never fires
        deadline = time.monotonic() + 60
        while not ws[0].executor._handoff_dest_ready:
            assert time.monotonic() < deadline, "the decode worker never warmed"
            time.sleep(0.05)
        snaps = []
        note = model._note_serving

        def spy(resp):
            if isinstance(resp.get("serving"), dict):
                snaps.append(dict(resp["serving"]))
            return note(resp)

        model._note_serving = spy
        streams = [[], []]
        results, errors = [None, None], [None, None]

        def go(i):
            try:
                results[i] = model.generate(
                    [prompts[i]], max_new_tokens=24, continuous=True,
                    stream_cb=lambda t, i=i: streams[i].extend(
                        x for x in t if x is not None))[0]
            except BaseException as e:  # noqa: BLE001 — asserted below
                errors[i] = e

        threads = [threading.Thread(target=go, args=(i,), daemon=True)
                   for i in (0, 1)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        cfg = config_from_jax(dataclasses.asdict(JCFG))
        from tensorlink_tpu_torch.engine.loader import load_params

        want = _slot_greedy("port", load_params(ckpt, cfg, device="cpu")[1],
                            prompts, 24)
        _finish(threads, streams, results, errors, want)
        assert want == _slot_greedy("jax", _jax_params(ckpt, False),
                                    prompts, 24)
        assert model.plan.stages[0].worker_id != ws[0].node_id
        dec = [s for s in snaps if s.get("worker_role") == "decode"]
        assert any(s["migrations_adopted"] >= 1 for s in dec), snaps
        for s in snaps:
            assert (s["kv_pages_free"] + s["prefix_resident_pages"]
                    + s["kv_pages_slots"] + s["pages_in_transit"]
                    == s["kv_pages_total"]), s
        model.shutdown()
    finally:
        _stop([user, *ws, v])

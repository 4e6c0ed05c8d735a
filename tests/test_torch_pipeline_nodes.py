"""Pipelined serving over the port's node stack, against the JAX package:
a tiny float32 llama with a tied head, written by the JAX exporter, split
by the planner over two port workers (``MLConfig(device="cpu")``), with
stage 0 holding the embedding and the tied head (the head hop).

- tests/test_nodes_e2e.py::test_pipelined_forward_and_generate_parity as
  a scenario: a port cluster and a JAX cluster on the same checkpoint,
  both split in two; the logits within 2e-5, greedy, batched per-row
  budgets, seeded sampled, penalized, beam (with and without EOS) and
  lookahead tokens equal, and every call rode the worker-to-worker chain;
- the chaos scenarios of tests/test_chaos_e2e.py on the port: every
  FORWARD frame sent twice (:230) and one dropped (:257) still give the
  fault-free tokens (session ops are seq-deduped), and a stage worker
  killed mid-step under the pipelined ``ContinuousBatcher`` (:364) lets
  both requests finish equal to their fault-free runs.

The fault-free reference is the JAX package's ``GenerationEngine`` on the
checkpoint's weights. Each test starts its own cluster and every request
has a timeout, so the tests hold under ``-n 6 --dist load`` in any
order."""

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
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax

pytestmark = pytest.mark.e2e
torch.set_num_threads(1)

JCFG = JModelConfig(
    family="llama", vocab_size=512, d_model=128, n_layers=6, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, max_seq_len=64,
    tie_embeddings=True, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
# capacities that split the job over workers 0 and 1 (tests/test_chaos_e2e.py
# _pin_two_stages); a third worker starts too small to be planned
CAPS = (3_000_000.0, 2_900_000.0, 1_000_000.0)
TIMEOUT = 60.0  # every cluster request
PROMPT = (7, 3, 200)
P2 = (5, 9, 100, 7)
REP = ((7, 3, 200, 9) * 5)[:18]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(11)))
    return str(j_export_hf(JCFG, jp, tmp_path_factory.mktemp("ckpt") / "m"))


@lru_cache(maxsize=None)
def _jax_engine(ckpt: str):
    from tensorlink_tpu.engine.generate import GenerationEngine
    from tensorlink_tpu.engine.loader import load_params

    _, params = load_params(ckpt, JCFG)
    return GenerationEngine(JCFG, params, max_seq_len=64)


def _greedy(ckpt, prompt, n):
    return _jax_engine(ckpt).generate_compiled(
        [list(prompt)], max_new_tokens=n).sequences[0]


def _cluster(pkg: str, tmp, *, n_workers=2, worker_faults=None,
             user_faults=None):
    """A validator, ``n_workers`` workers and a user of one package on
    127.0.0.1, the workers' capacities pinned to split the job."""
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.nodes.runners import (
            UserNode,
            ValidatorNode,
            WorkerNode,
        )

        ml = C.MLConfig(device="cpu")
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.nodes.runners import (
            UserNode,
            ValidatorNode,
            WorkerNode,
        )

        ml = C.MLConfig()
    common = dict(local_test=True, key_dir=str(tmp / "keys"),
                  log_dir=str(tmp / "logs"), env_file=str(tmp / ".env"),
                  ml=ml)
    nodes = []
    try:
        v = ValidatorNode(C.ValidatorConfig(
            endpoint=False, monitor_interval=0.5, keeper_interval=5.0,
            proposal_interval=0.0, **common)).start()
        nodes.append(v)
        seeds = [["127.0.0.1", v.port]]
        for i in range(n_workers):
            nodes.append(WorkerNode(C.WorkerConfig(
                seed_validators=seeds, duplicate=str(i) if i else "",
                faults=(worker_faults or {}).get(i, {}), **common)).start())
        nodes.append(UserNode(C.UserConfig(
            seed_validators=seeds, faults=user_faults or {},
            **common)).start())
        deadline = time.monotonic() + 60
        while (len(v.status()["peers"]) < n_workers + 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        for w, cap in zip(nodes[1:-1], CAPS):
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


def _model(pkg, user, ckpt, request_timeout=TIMEOUT):
    if pkg == "port":
        from tensorlink_tpu_torch.ml.module import DistributedModel

        return DistributedModel(CFG, node=user, ckpt=ckpt, seq_len=64,
                                batch=1, device="cpu",
                                request_timeout=request_timeout)
    from tensorlink_tpu.ml.module import DistributedModel as JModel

    return JModel(JCFG, node=user, ckpt=ckpt, seq_len=64, batch=1,
                  request_timeout=request_timeout)


def _drive(model, toks):
    """Every pipelined path of ``model``, in one order for both
    packages."""
    out = {"logits": np.asarray(model(toks))}
    out["greedy"] = model.generate([PROMPT], max_new_tokens=6)
    out["budgets"] = model.generate(
        [PROMPT, P2], max_new_tokens=6, temperature=[0.0, 0.0],
        top_k=[0, 0], top_p=[1.0, 1.0], budgets=[6, 3])
    out["sampled"] = [
        model.generate([PROMPT], max_new_tokens=6, temperature=0.8, seed=s)
        for s in (123, 123, 124)]
    out["penalized"] = model.generate(
        [PROMPT, P2], max_new_tokens=6, temperature=[0.0, 0.0],
        top_k=[0, 0], top_p=[1.0, 1.0], presence_penalty=[1.5, 0.0],
        frequency_penalty=[0.5, 0.0])
    out["lookahead"] = [model.generate([p], max_new_tokens=8, lookahead=True)
                        for p in (PROMPT, REP)]
    out["beam"] = model.generate([PROMPT], max_new_tokens=8, num_beams=3)
    eos = out["greedy"][0][2]
    out["beam_eos"] = model.generate([PROMPT], max_new_tokens=8, num_beams=3,
                                     eos_ids=[eos])
    out["chained"] = model.chain_forwards
    return out


def test_pipelined_forward_and_generate_parity(tmp_path, checkpoint):
    """A port cluster and a JAX cluster on one checkpoint, each split in
    two with the tied head on stage 0: equal logits (2e-5) and tokens on
    every pipelined path, all through the worker-to-worker chain."""
    toks = np.array([[4, 8, 15, 16, 23, 42]], np.int32)
    got = {}
    for pkg in ("port", "jax"):
        v, ws, user = _cluster(pkg, tmp_path / pkg)
        try:
            model = _model(pkg, user, checkpoint)
            assert model.plan.n_stages == 2, model.plan
            s0, s1 = model.plan.stages
            assert s0.holds_head and not s1.holds_head  # the head hop
            got[pkg] = _drive(model, toks)
            model.shutdown()
        finally:
            _stop([user, *ws, v])
    port, ref = got["port"], got["jax"]
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=2e-5,
                               atol=2e-5)
    for key in ("greedy", "budgets", "sampled", "penalized", "lookahead",
                "beam", "beam_eos"):
        assert port[key] == ref[key], key
    assert port["greedy"][0] == _greedy(checkpoint, PROMPT, 6)
    assert len(port["budgets"][1]) == 3
    s1, s2, s3 = port["sampled"]
    assert s1 == s2 != s3
    assert port["chained"] > 0 and ref["chained"] > 0


@pytest.mark.parametrize("fault", ["dup", "drop"])
def test_session_frames_apply_once(tmp_path, checkpoint, fault):
    """Every FORWARD frame out of the user sent twice, or the third one
    dropped (the seq-numbered retry after a 5 s timeout): the workers
    dedup the session ops and the decode gives the fault-free tokens."""
    rule = ({"site": "p2p.send", "op": "dup", "prob": 1.0,
             "key_substr": "fwd", "max_fires": None} if fault == "dup"
            else {"site": "p2p.send", "op": "drop", "nth": 3,
                  "key_substr": "fwd"})
    v, ws, user = _cluster("port", tmp_path,
                           user_faults={"seed": 1, "rules": [rule]})
    try:
        model = _model("port", user, checkpoint,
                       request_timeout=5.0 if fault == "drop" else TIMEOUT)
        assert model.plan.n_stages == 2
        seqs = model.generate([PROMPT], max_new_tokens=8)
        assert seqs[0] == _greedy(checkpoint, PROMPT, 8)
        model.shutdown()
    finally:
        _stop([user, *ws, v])


def test_pipelined_slot_admission_with_crash_recovery(tmp_path, checkpoint):
    """The pipelined ``ContinuousBatcher`` admits a second request
    mid-flight; stage 0's worker dies at its 6th session op; the slot set
    re-establishes on the spare and both requests finish equal to their
    fault-free runs, streams included."""
    from tensorlink_tpu_torch.ml.batching import ContinuousBatcher

    v, ws, user = _cluster(
        "port", tmp_path, n_workers=3,
        worker_faults={0: {"seed": 7, "rules": [
            {"site": "worker.session_step", "op": "crash", "nth": 6}]}})
    try:
        model = _model("port", user, checkpoint)
        assert model.plan.n_stages == 2
        assert model.plan.stages[0].worker_id == ws[0].node_id
        ws[2].send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        b = ContinuousBatcher(model, eos_ids=[], max_slots=2)
        assert b.mode == "pipelined"
        prompts, n_toks = [list(PROMPT), [9, 1, 2]], [12, 8]
        out, streams = {}, {0: [], 1: []}

        def go(i):
            out[i] = b.generate(prompts[i], max_new_tokens=n_toks[i],
                                stream_cb=streams[i].extend, timeout=TIMEOUT)

        threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        threads[0].start()
        time.sleep(0.3)  # the second request admits mid-flight
        threads[1].start()
        for t in threads:
            t.join(TIMEOUT)
        b.close()
        assert model.plan.stages[0].worker_id != ws[0].node_id
        for i in (0, 1):
            want = _greedy(checkpoint, prompts[i], n_toks[i])
            assert out.get(i) == want, (i, out.get(i), want)
            assert streams[i] == want
        model.shutdown()
    finally:
        _stop([user, *ws, v])


@pytest.mark.parametrize("case,item", [("coworkers", 4)])
def test_split_plans_the_port_refuses_at_attach(case, item):
    """Attach takes a plan of several stages, for serving or training
    (tests/test_torch_pipeline_train_nodes.py); a co-slice one (ROADMAP
    queue 1 item 4) still raises before any worker is dialed."""
    import types

    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.parallel.planner import (
        WorkerCapacity,
        plan_sharding,
    )

    plan = plan_sharding(CFG, [WorkerCapacity(str(i), c)
                               for i, c in enumerate(CAPS)],
                         batch=1, seq_len=64, training=False)
    assert plan.n_stages == 2
    plan.stages[1].coworkers = ["2"]
    node = types.SimpleNamespace(
        connect_to=lambda *a: pytest.fail("a worker was dialed"))
    model = DistributedModel(CFG, node=node, start_session=False,
                             device="cpu")
    reply = {"job_id": "j", "plan": plan.to_json(), "workers": {},
             "model": {"name": "custom", "config": CFG.to_json()}}
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}"):
        model._attach(reply)

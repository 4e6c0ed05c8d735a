"""Pipelined training over the port's node stack, against the JAX
package: a tiny float32 llama with a tied head (tests/test_training_e2e.py
``tiny_cfg(n_layers=6, d_model=64, d_ff=128, tie_embeddings=True)``),
seeded with the JAX initializer and written by the JAX exporter, trained
split over two port workers (``MLConfig(device="cpu")``) with stage 0
holding the embedding and the tied head.

- tests/test_training_e2e.py::test_pipelined_tied_training_parity on the
  port: the losses and the merged params against the JAX package's
  compiled step on the same tree, under the JAX test's bounds (losses
  rtol 2e-4, atol 1e-5; ``embed.tok`` and ``w_gate`` rtol 3e-4, atol
  3e-5), with the micro-batches overlapped across the stages;
- overlap against the serial loop from one checkpoint: losses within
  1e-5 relative, with at least two micro-batches seen in flight (counted
  on the driver's requests, not timed);
- a two-stage checkpoint save, restore and HF export whose merged tree
  equals the single-program tree within the parity bounds, with a proof
  log on each stage's worker;
- the two crashes of a two-stage step, each against the JAX compiled
  chain replayed from the checkpoint the job rolled back to: the stage-1
  worker crashed inside the optimizer after stage 0 applied its update,
  and the stage-0 worker stopped between a micro-batch's FORWARD and its
  BACKWARD.

Each test starts its own cluster and every request has a timeout, so the
tests hold under ``-n 6 --dist load`` in any order."""

import dataclasses
import threading
import time
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import training as jtrain
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
    family="llama", vocab_size=128, d_model=64, n_layers=6, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=128, max_seq_len=64,
    tie_embeddings=True, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
B, T, SEQ = 4, 12, 32  # the JAX test's batch, tokens and job seq_len
LR = 1e-3
# tlint: disable=TL006(read-only test bounds — never mutated)
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_training_e2e.py:157
# tlint: disable=TL006(read-only test bounds — never mutated)
PARAM_TOL = dict(rtol=3e-4, atol=3e-5)
TIMEOUT = 120.0  # every cluster request


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(5)))
    return str(j_export_hf(JCFG, jp, tmp_path_factory.mktemp("ckpt") / "m"))


@lru_cache(maxsize=None)
def _jax_params(path: str):
    return j_load_params(path, JCFG)[1]


def _batches(n, seed=123):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, (B, T)).astype(np.int32)
            for _ in range(n)]


def _local_reference(path, batches):
    """The JAX package's compiled single-program steps from the
    checkpoint's tree (tests/test_training_e2e.py::_local_reference):
    (params, losses)."""
    params = _jax_params(path)
    opt = jtrain.make_optimizer("adamw", lr=LR, grad_clip=1.0)
    ts = jtrain.make_train_step(JCFG, opt, n_micro=1, donate=False)
    state, losses = ts.init_state(params), []
    for toks in batches:
        params, state, m = ts.step_fn(params, state,
                                      {"tokens": toks, "loss_mask": None})
        losses.append(float(m["loss"]))
    return params, losses


def _two_stage_caps():
    """Advertised bytes that make the training planner split the job
    (batch B, seq_len SEQ) over workers 0 and 1, half the layers each
    with the tied head on stage 0, and plan nothing on worker 2; each
    stage's recruit estimate fits its worker."""
    from tensorlink_tpu_torch.parallel.planner import (
        MemoryEstimate,
        WorkerCapacity,
        plan_sharding,
    )

    est = MemoryEstimate.build(CFG, batch=B, seq_len=SEQ, training=True)
    emb = CFG.vocab_size * CFG.d_model * 4
    per_layer = (est.total - 2 * emb) / CFG.n_layers
    half = CFG.n_layers // 2
    caps = (emb + (half + 0.5) * per_layer, emb + (half + 0.25) * per_layer,
            1e4)
    plan = plan_sharding(CFG, [WorkerCapacity(str(i), c)
                               for i, c in enumerate(caps)],
                         batch=B, seq_len=SEQ, training=True)
    assert [(s.worker_id, s.layer_lo, s.layer_hi) for s in plan.stages] == \
        [("0", 0, half), ("1", half, CFG.n_layers)], plan
    assert all(est.total * half / CFG.n_layers <= c for c in caps[:2])
    return caps


# -- clusters ----------------------------------------------------------------
def _common(tmp):
    return dict(local_test=True, key_dir=str(tmp / "keys"),
                log_dir=str(tmp / "logs"), env_file=str(tmp / ".env"))


def _wait(pred, what, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _cluster(tmp, n_workers=2, faults=None):
    """A port validator, ``n_workers`` workers on the host and a user on
    127.0.0.1, the capacities pinned to split the job over workers 0
    and 1 (a third starts too small to be planned)."""
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    nodes = []
    try:
        nodes.append(ValidatorNode(ValidatorConfig(
            endpoint=False, monitor_interval=0.5, keeper_interval=1.0,
            proposal_interval=0.0, ml=MLConfig(device="cpu"),
            **_common(tmp))).start())
        seeds = [["127.0.0.1", nodes[0].port]]
        for i in range(n_workers):
            nodes.append(WorkerNode(WorkerConfig(
                seed_validators=seeds, duplicate=str(i) if i else "",
                faults=(faults or {}).get(i, {}),
                ml=MLConfig(device="cpu"), **_common(tmp))).start())
        nodes.append(UserNode(UserConfig(seed_validators=seeds,
                                         **_common(tmp))).start())
        _wait(lambda: len(nodes[0].status()["peers"]) >= n_workers + 1,
              "peers")
        for w, cap in zip(nodes[1:-1], _two_stage_caps()):
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


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    v, ws, user = _cluster(tmp_path_factory.mktemp("cluster"))
    yield v, ws, user
    _stop([user, *ws, v])


def _model(user, path, ws, **kw):
    from tensorlink_tpu_torch.ml.module import DistributedModel

    model = DistributedModel(CFG, node=user, ckpt=path, seq_len=SEQ,
                             batch=B, training=True, device="cpu",
                             request_timeout=TIMEOUT, **kw)
    assert model.plan.n_stages == 2, model.plan
    s0, s1 = model.plan.stages
    assert s0.holds_head and not s1.holds_head  # the tied head's hop
    assert [s.worker_id for s in model.plan.stages] == \
        [ws[0].node_id, ws[1].node_id]
    model.init_optimizer("adamw", lr=LR)
    return model


class _InFlight:
    """The most train FORWARD/BACKWARD requests the driver had open at
    once: two means two micro-batches in flight (each driver thread
    waits on one request at a time)."""

    def __init__(self, model):
        self.now = self.most = 0
        self._lock = threading.Lock()
        real = model._request

        def request(wid, tag, body, *a, **kw):
            counted = "tag" in body
            if counted:
                with self._lock:
                    self.now += 1
                    self.most = max(self.most, self.now)
            try:
                return real(wid, tag, body, *a, **kw)
            finally:
                if counted:
                    with self._lock:
                        self.now -= 1

        model._request = request


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _merged(model):
    return model._merge_stage_params(model.parameters())


def _held_params(merged, ref):
    np.testing.assert_allclose(merged["embed"]["tok"],
                               np.asarray(ref["embed"]["tok"]), **PARAM_TOL)
    np.testing.assert_allclose(merged["layers"]["mlp"]["w_gate"],
                               np.asarray(ref["layers"]["mlp"]["w_gate"]),
                               **PARAM_TOL)


# -- parity ------------------------------------------------------------------
def test_pipelined_tied_training_parity(cluster, ckpt):
    """Two steps of the split job, its 4 micro-batches overlapped in 3
    driver threads with the interpreter switching threads every 10 us:
    the losses and the merged tree (the tied embedding, which both of
    stage 0's gradients reach, and a layer leaf from each stage) equal
    the JAX compiled step's, so no micro-batch's gradient was lost."""
    import sys

    v, ws, user = cluster
    batches = _batches(2)
    ref_params, ref_losses = _local_reference(ckpt, batches)
    model = _model(user, ckpt, ws)
    interval = sys.getswitchinterval()
    try:
        assert model.plan.n_micro == 4
        flight = _InFlight(model)
        sys.setswitchinterval(1e-5)
        losses = [model.train_step(t)["loss"] for t in batches]
        sys.setswitchinterval(interval)
        np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL)
        assert flight.most >= 2, flight.most
        _held_params(_merged(model), ref_params)
    finally:
        sys.setswitchinterval(interval)
        model.shutdown()


def test_overlap_equals_serial(cluster, ckpt, tmp_path):
    """From one checkpoint, two overlapped steps and two serial ones:
    the losses agree within 1e-5 relative (the BACKWARDs arrive in
    another order, so the gradient sums are not bitwise), and only the
    overlapped steps had two micro-batches in flight."""
    v, ws, user = cluster
    batches = _batches(2, seed=7)
    model = _model(user, ckpt, ws, n_micro=2)
    try:
        assert model.plan.n_micro == 2
        model.save_checkpoint(str(tmp_path / "start"))
        flight = _InFlight(model)
        over = [model.train_step(t)["loss"] for t in batches]
        assert flight.most == 2, flight.most
        model.restore_checkpoint(str(tmp_path / "start"))
        flight.most = 0
        serial = [model.train_step(t, overlap=False)["loss"]
                  for t in batches]
        assert flight.most == 1, flight.most
        np.testing.assert_allclose(serial, over, rtol=1e-5, atol=0)
        np.testing.assert_allclose(serial, _local_reference(ckpt, batches)[1],
                                   **LOSS_TOL)
    finally:
        model.shutdown()


def test_two_stage_checkpoint_restore_and_export(cluster, ckpt, tmp_path):
    """A step, a checkpoint, a diverging step, a restore: each stage's
    tree is back bitwise. The HF export of the merged tree, read by the
    JAX loader, equals the single-program tree after that step; each
    stage's worker logged a proof entry per optimizer step."""
    v, ws, user = cluster
    batches = _batches(2, seed=9)
    ref_params, _ = _local_reference(ckpt, batches[:1])
    model = _model(user, ckpt, ws)
    try:
        model.train_step(batches[0])
        model.save_checkpoint(str(tmp_path / "ck"))
        snap = model.parameters()
        model.train_step(batches[1])
        moved = model.parameters()
        assert not np.array_equal(snap[0]["embed"]["tok"],
                                  moved[0]["embed"]["tok"])
        model.restore_checkpoint(str(tmp_path / "ck"))
        back = model.parameters()
        for s, b in zip(snap, back):
            assert _named(s).keys() == _named(b).keys()
            for k, a in _named(s).items():
                np.testing.assert_array_equal(a, _named(b)[k], err_msg=k)
        out = model.export_hf_checkpoint(str(tmp_path / "hf"))
        _, exported = j_load_params(str(out), JCFG)
        _held_params(jax.device_get(exported), ref_params)
        np.testing.assert_allclose(
            np.asarray(exported["layers"]["attn"]["wo"]),
            np.asarray(ref_params["layers"]["attn"]["wo"]), **PARAM_TOL)
        pol = v.send_request("job_proofs", {"job_id": model.job_id},
                             timeout=TIMEOUT)
        verdicts = pol["verdicts"]
        assert sorted(verdicts) == sorted([ws[0].node_id, ws[1].node_id])
        assert all(x["total_steps"] == 2 for x in verdicts.values()), pol
    finally:
        model.shutdown()


# -- repair ------------------------------------------------------------------
def _jax_chain(path, batches):
    return _local_reference(path, batches)[1]


def test_crash_inside_optimizer_rolls_back_both_stages(tmp_path, ckpt):
    """The stage-1 worker crashes at its 4th optimizer step, after stage
    0 applied that step's update. With ``ckpt_every_steps=2`` the job
    repairs onto the spare, rolls BOTH stages back to the step-2
    checkpoint and trains on: every loss equals the JAX chain over the
    batches the job really trained (1, 2, 3, then 1, 2, 4, 5, 6)."""
    import json

    batches = _batches(6, seed=3)
    v, ws, user = _cluster(tmp_path, n_workers=3, faults={1: {
        "seed": 3, "rules": [{"site": "worker.train_step", "op": "crash",
                              "nth": 4}]}})
    try:
        model = _model(user, ckpt, ws, ckpt_every_steps=2,
                       ckpt_dir=str(tmp_path / "ck"))
        ws[2].send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        losses = [model.train_step(b)["loss"] for b in batches]
        stage1, step = model.plan.stages[1].worker_id, model._step
        # stage 0 applied the crashed step's update before the rollback:
        # 4 steps, then the re-driven 3rd to 6th
        applied0 = ws[0].executor.jobs[model.job_id].opt_steps
        model.shutdown()
    finally:
        _stop([user, *ws, v])
    assert stage1 == ws[2].node_id and step == 5, (stage1, step)
    assert applied0 == 7, applied0
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["step"] == 4
    first3 = _jax_chain(ckpt, batches[:3])
    after = _jax_chain(ckpt, batches[:2] + batches[3:])
    np.testing.assert_allclose(losses[:3], first3, **LOSS_TOL)
    np.testing.assert_allclose(losses[3:], after[2:], **LOSS_TOL)


def test_stage0_stopped_before_backward_redrives_the_step(tmp_path, ckpt):
    """The stage-0 worker (the embedding and the tied head) stops after a
    micro-batch's train FORWARD and before its BACKWARD, in step 3. The
    job re-ships stage 0 to the spare, restores the step-2 checkpoint on
    both stages and re-drives step 3: the losses stay on the JAX chain,
    since the rollback lands where the failed step began."""
    batches = _batches(5, seed=4)
    v, ws, user = _cluster(tmp_path, n_workers=3)
    try:
        model = _model(user, ckpt, ws, ckpt_every_steps=2,
                       ckpt_dir=str(tmp_path / "ck"))
        ws[2].send_request("set_capacity", {"hbm_bytes": 8e9, "n_devices": 1})
        real_bwd, stopped = model._train_backward, []

        def backward(dlogits, tag):
            if tag == "s3m0" and not stopped:
                ws[0].stop()
                stopped.append(tag)
            return real_bwd(dlogits, tag)

        model._train_backward = backward
        losses = [model.train_step(b)["loss"] for b in batches]
        stage0, step = model.plan.stages[0].worker_id, model._step
        model.shutdown()
    finally:
        _stop([user, *ws, v])
    assert stopped and stage0 == ws[2].node_id and step == 5, (stage0, step)
    np.testing.assert_allclose(losses, _jax_chain(ckpt, batches), **LOSS_TOL)

"""Training and user jobs over the port's node stack against the JAX
package, on one tiny float32 llama whose weights the JAX exporter wrote:

- one port cluster (validator, worker on the host, user) serves the
  ports of tests/test_training_e2e.py's single-stage tests with the JAX
  test's bounds: training parity against the JAX package's compiled
  step (losses rtol 1e-4, atol 1e-5; params rtol 2e-4, atol 2e-5) with
  the validator's proof verdicts, checkpoint save and restore, HF export
  and the distributed optimizer factory;
- TLTS training checkpoints cross the packages: a checkpoint one
  package's worker wrote restores into the other's CHECKPOINT handler
  (params and optimizer state bitwise), and the next step matches the
  writer's (loss rtol 1e-5; params rtol 2e-5, atol 2e-6 under SGD with
  momentum, each leaf within 2e-4 in its norm under AdamW, as
  tests/test_torch_training.py);
- ``DistributedModel.forward`` logits equal a JAX cluster's within 2e-5,
  and its worker-sampled tokens equal.

Every cluster request gets a generous timeout: these run beside other
test files under load."""

import dataclasses
import queue
import time
import types

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
from tensorlink_tpu.p2p import protocol as jproto
from tensorlink_tpu.platform import proofs as jproofs
from tensorlink_tpu_torch.convert import config_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.ml.module import _ce_sum_and_grad

torch.set_num_threads(1)

pytestmark = pytest.mark.e2e

JCFG = JModelConfig(
    family="llama", vocab_size=128, d_model=48, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=96, max_seq_len=64, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
TIMEOUT = 300.0  # every cluster request


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX tree from a seed, written by the JAX exporter."""
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(21)))
    out = j_export_hf(JCFG, jp, tmp_path_factory.mktemp("jax_ckpt") / "m")
    return str(out), jp


def _start(pkg: str, tmp):
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
    common = dict(local_test=True, log_dir=str(tmp / "logs"),
                  env_file=str(tmp / ".env"), ml=ml)
    nodes = []
    try:
        v = ValidatorNode(C.ValidatorConfig(
            endpoint=False, key_dir=str(tmp / "vk"), **common)).start()
        nodes.append(v)
        seeds = [["127.0.0.1", v.port]]
        nodes.append(WorkerNode(C.WorkerConfig(
            seed_validators=seeds, key_dir=str(tmp / "wk"), **common)).start())
        nodes.append(UserNode(C.UserConfig(
            seed_validators=seeds, key_dir=str(tmp / "uk"), **common)).start())
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
    except BaseException:
        for n in reversed(nodes):
            n.stop()
        raise
    return nodes


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    nodes = _start("port", tmp_path_factory.mktemp("port_train"))
    yield {"validator": nodes[0], "worker": nodes[1], "user": nodes[2]}
    for n in reversed(nodes):
        n.stop()


def _model(cluster, ckpt, **kw):
    from tensorlink_tpu_torch.ml.module import DistributedModel

    return DistributedModel(CFG, node=cluster["user"], ckpt=ckpt, seq_len=64,
                            device="cpu", request_timeout=TIMEOUT, **kw)


def _batches(n, B=4, T=16, seed=123):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, size=(B, T)).astype(np.int32)
            for _ in range(n)]


def _local_reference(jp, batches, *, lr=1e-3):
    """The JAX package's compiled single-program steps, and each step's
    token-mean gradients at the params it starts from."""
    opt = jtrain.make_optimizer("adamw", lr=lr, grad_clip=1.0)
    ts = jtrain.make_train_step(JCFG, opt, n_micro=1, donate=False)
    grad_fn = jax.jit(jax.grad(
        lambda p, t: jtrain.causal_lm_loss(p, JCFG, t)[0]))
    params, state = jp, ts.init_state(jp)
    losses, grads = [], []
    for toks in batches:
        grads.append(jax.device_get(grad_fn(params, toks)))
        params, state, m = ts.step_fn(params, state, {"tokens": toks,
                                                      "loss_mask": None})
        losses.append(float(m["loss"]))
    return jax.device_get(params), losses, grads


# the proof of learning, as chip_smoke.py holds it: each logged gradient
# sketch against the sketch of the reference's gradients at the job's
# coordinates (cosine, so the worker's clipped sum-form gradients compare
# with the token-mean ones), and the verdict's median cosine against the
# reference log's
PROOF_SKETCH_COS = 0.999
PROOF_MEDIAN_ATOL = 0.02


def _reference_proof_log(grads, job_id: str) -> list:
    """The JAX package's proof log of ``grads`` at the job's coordinates
    (the worker seeds the sketch with ``int(job_id[:8], 16)``)."""
    log, prev = [], ""
    for i, g in enumerate(grads):
        norm = float(np.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                                 for x in jax.tree.leaves(g))))
        e = jproofs.proof_entry(
            i + 1, norm,
            jproofs.gradient_sketch(g, seed=int(job_id[:8], 16)), prev)
        log.append(e)
        prev = e["hash"]
    return log


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_single_stage_training_parity(cluster, checkpoint):
    ckpt, jp = checkpoint
    batches = _batches(5)
    ref_params, ref_losses, ref_grads = _local_reference(jp, batches)
    with _model(cluster, ckpt, seed=21, training=True) as model:
        assert model.plan.n_stages == 1
        model.init_optimizer("adamw", lr=1e-3)
        losses = [model.train_step(t)["loss"] for t in batches]
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
        pol = cluster["validator"].send_request(
            "job_proofs", {"job_id": model.job_id}, timeout=TIMEOUT)
        verdicts = pol["verdicts"]
        assert verdicts, pol
        # the verdict's ok is a draw over the job id's coordinates (on
        # structureless tokens consecutive gradients share no direction):
        # hold the logged sketches and the verdict to the reference's own
        # at the same coordinates instead
        log = cluster["worker"].executor.jobs[model.job_id].proof_log
        ref_log = _reference_proof_log(ref_grads, model.job_id)
        assert [e["step"] for e in log] == [e["step"] for e in ref_log]
        cosines = [_cos(a["sketch"], b["sketch"])
                   for a, b in zip(log, ref_log)]
        assert min(cosines) >= PROOF_SKETCH_COS, cosines
        ref_ok, ref_detail = jproofs.verify_proof_log(ref_log)
        for wid, v in verdicts.items():
            assert v["total_steps"] == len(batches)
            assert abs(v["median_cosine"] - ref_detail["median_cosine"]) \
                <= PROOF_MEDIAN_ATOL, (wid, v, ref_detail)
            if abs(ref_detail["median_cosine"] + 0.2) > PROOF_MEDIAN_ATOL:
                # off the bar's edge the two verdicts agree
                assert (v["ok"], v.get("reason")) == (
                    ref_ok, ref_detail.get("reason")), (wid, v, ref_detail)
        got = model.parameters()[0]
    np.testing.assert_allclose(got["embed"]["tok"], ref_params["embed"]["tok"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["layers"]["attn"]["wq"],
                               ref_params["layers"]["attn"]["wq"],
                               rtol=2e-4, atol=2e-5)


def test_checkpoint_save_restore(cluster, checkpoint, tmp_path):
    ckpt, _ = checkpoint
    batches = _batches(2)
    with _model(cluster, ckpt, seed=3, training=True) as model:
        model.init_optimizer("adamw", lr=1e-3)
        model.train_step(batches[0])
        model.save_checkpoint(str(tmp_path / "ckpt"))
        snap = model.parameters()[0]
        first = model.train_step(batches[1])  # diverge
        moved = model.parameters()[0]
        assert not np.allclose(snap["embed"]["tok"], moved["embed"]["tok"])

        model.restore_checkpoint(str(tmp_path / "ckpt"))
        back = model.parameters()[0]
        for a, b in zip(topt.tree_leaves(back), topt.tree_leaves(snap)):
            np.testing.assert_array_equal(a, b)
        # the optimizer state came back too: the step after the restore
        # repeats the step after the save exactly
        again = model.train_step(batches[1])
        assert again["loss"] == first["loss"]
        for a, b in zip(topt.tree_leaves(model.parameters()[0]),
                        topt.tree_leaves(moved)):
            np.testing.assert_array_equal(a, b)


def test_hf_export_roundtrip(cluster, checkpoint, tmp_path):
    from tensorlink_tpu_torch.engine.loader import load_params

    ckpt, _ = checkpoint
    with _model(cluster, ckpt, seed=9) as model:
        out = model.export_hf_checkpoint(str(tmp_path / "hf"))
        merged = model._merge_stage_params(model.parameters())
    _, jloaded = j_load_params(out, JCFG)
    _, tloaded = load_params(out, CFG, device="cpu")
    want = topt.tree_leaves(merged)
    for j, t, w in zip(jax.tree.leaves(jax.device_get(jloaded)),
                       topt.tree_leaves(tloaded), want, strict=True):
        np.testing.assert_array_equal(np.asarray(j), w)
        np.testing.assert_array_equal(t.numpy(), w)


def test_distributed_optimizer_factory(cluster, checkpoint):
    from tensorlink_tpu_torch.ml.optim import create_distributed_optimizer

    ckpt, _ = checkpoint
    with _model(cluster, ckpt, seed=1, training=True) as model:
        opt = create_distributed_optimizer(model, "adamw", lr=1e-3)
        r = model.train_step(_batches(1)[0], step_optimizer=False)
        assert np.isfinite(r["loss"])
        out = opt.step(scale=1.0 / max(r["n_tokens"], 1))
        assert out["grad_norm"] > 0
        opt.zero_grad()


# -- bare workers: the training verbs driven directly ----------------------
JOB = "ab12cd34"


class Bridge:
    """The ML side of the IPC bridge: responses recorded."""

    def __init__(self):
        self.q = types.SimpleNamespace(work=queue.Queue())
        self.sent = []

    def request(self, verb, payload=None, timeout=None):
        self.sent.append((verb, payload))

    notify = request


def bare_worker(pkg: str):
    """A DistributedWorker of either package with a recording bridge (the
    port's on the host)."""
    if pkg == "port":
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        ml = C.MLConfig(device="cpu")
    else:
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.ml.worker import DistributedWorker

        ml = C.MLConfig()
    node = types.SimpleNamespace(
        bridge=Bridge(), node_id=f"{pkg}-w0", config=C.WorkerConfig(ml=ml),
        crash=lambda: None)
    return DistributedWorker(node)


def call(w, kind: str, **body):
    """One work item through the worker's handler; returns (tag, reply)."""
    n = len(w.bridge.sent)
    w._handle(kind, {"rid": "r1", "peer": "p1", "job_id": JOB, **body})
    [(verb, payload)] = w.bridge.sent[n:]
    assert verb == "respond" and payload["rid"] == "r1"
    return payload["tag"], payload["body"]


def load_training_job(w, ckpt: str, training: bool = True):
    stage = {"worker_id": "w0", "layer_lo": 0, "layer_hi": JCFG.n_layers,
             "first": True, "last": True, "holds_head": True,
             "mesh_axes": {}, "coworkers": []}
    return call(w, "load_stage", stage=stage, training=training,
                model={"name": "tiny", "config": JCFG.to_json(),
                       "ckpt": ckpt, "seed": 0})


def train_step(w, toks, tag: str) -> float:
    """A driver's step on one bare worker: train forward, the
    cross-entropy gradient here, backward, optimizer step."""
    _, out = call(w, "fwd", op="stage", train=True, tag=tag, tokens=toks)
    logits = torch.as_tensor(np.array(out["out"]))
    nll, dlogits, n = _ce_sum_and_grad(logits, toks,
                                       np.ones(toks.shape, bool))
    call(w, "bwd", op="stage", tag=tag, grad=dlogits.numpy())
    call(w, "opt", op="step", scale=1.0 / float(n))
    return float(nll) / float(n)


def params_of(w) -> list[np.ndarray]:
    _, body = call(w, "params.req")
    return [np.asarray(a) for a in topt.tree_leaves(body["params"])]


def opt_state_leaves(w) -> list[np.ndarray]:
    """The worker's optimizer state, flattened in jax.tree.leaves order."""
    st = w.jobs[JOB].opt_state
    if type(w).__module__.startswith("tensorlink_tpu_torch"):
        return [t.numpy() for t in topt.tree_leaves(st)]
    return [np.asarray(x) for x in jax.tree.leaves(st)]


# tlint: disable=TL006(read-only constant table)
CROSS_OPTS = {
    "sgd momentum": ({"name": "sgd", "lr": 0.1, "momentum": 0.9},
                     dict(rtol=2e-5, atol=2e-6)),
    "adamw": ({"name": "adamw", "lr": 1e-3}, None),
}


@pytest.mark.parametrize("opt", list(CROSS_OPTS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tlts_training_checkpoint_crosses_packages(checkpoint, tmp_path,
                                                   writer, opt):
    ckpt, _ = checkpoint
    spec, ptol = CROSS_OPTS[opt]
    reader = "port" if writer == "jax" else "jax"
    src, dst = bare_worker(writer), bare_worker(reader)
    b0, b1 = _batches(2, seed=7)
    for w in (src, dst):
        load_training_job(w, ckpt)
        call(w, "opt", op="init", spec={**spec, "grad_clip": None})
    train_step(src, b0, "s1m0")
    _, saved = call(src, "ckpt", op="save", dir=str(tmp_path))
    assert saved["ok"] and saved["path"].endswith(
        f"stage_0_{JCFG.n_layers}.tlts")
    tag, restored = call(dst, "ckpt", op="restore", dir=str(tmp_path))
    assert tag == jproto.CHECKPOINT_RESP
    assert restored == {"ok": True, "restored_opt": True,
                        "opt_in_checkpoint": True}
    for a, b in zip(params_of(dst), params_of(src), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(opt_state_leaves(dst), opt_state_leaves(src),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    l_src = train_step(src, b1, "s2m0")
    l_dst = train_step(dst, b1, "s2m0")
    np.testing.assert_allclose(l_dst, l_src, rtol=1e-5)
    for a, b in zip(params_of(dst), params_of(src), strict=True):
        if ptol is not None:
            np.testing.assert_allclose(a, b, **ptol)
        else:
            assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_cluster(tmp_path_factory):
    nodes = _start("jax", tmp_path_factory.mktemp("jax_train"))
    yield {"validator": nodes[0], "worker": nodes[1], "user": nodes[2]}
    for n in reversed(nodes):
        n.stop()


def test_forward_logits_equal_a_jax_cluster(cluster, jax_cluster, checkpoint):
    from tensorlink_tpu.ml.module import DistributedModel as JModel

    ckpt, _ = checkpoint
    toks = _batches(1, B=3, T=12, seed=4)[0]
    am = np.ones(toks.shape, bool)
    am[1, 9:] = False
    sample = {"temperature": 0.8, "top_k": 5, "seed": 3, "step": 1}
    with JModel(JCFG, node=jax_cluster["user"], ckpt=ckpt, seq_len=64,
                request_timeout=TIMEOUT) as jm:
        want = np.asarray(jm.forward(toks, am))
        want_greedy = jm.forward(toks, am, sample={"temperature": 0.0},
                                 last_idx=[11, 8, 11])
        want_sampled = jm.forward(toks, am, sample=sample)
    with _model(cluster, ckpt) as tm:
        got = tm.forward(toks, am)
        got_greedy = tm.forward(toks, am, sample={"temperature": 0.0},
                                last_idx=[11, 8, 11])
        got_sampled = tm(toks, am, sample=sample)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert np.array_equal(got_greedy, want_greedy)
    assert np.array_equal(got_sampled, want_sampled)

"""Serve-and-train in the port (``engine/serve_train.py``): the ports of
tests/test_serve_train.py's loop tests — the loop needs a local engine,
its tick yields to foreground work, steps, publishes on its cadence and
stops, and it trains and publishes while a best_effort stream decodes on
a tiny float32 model — and the loop held against the JAX package: after
the same steps the published tree is within make_train_step's bounds of
JAX's (SGD with momentum, rtol 2e-5, atol 2e-6, as
tests/test_torch_training.py), and greedy streams served after the
publish equal a JAX ContinuousEngine's over JAX's trained tree."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import training as jtrain
from tensorlink_tpu.engine.continuous import ContinuousEngine as JEngine
from tensorlink_tpu.engine.generate import GenerationEngine as JGen
from tensorlink_tpu.models import ModelConfig as JModelConfig
from tensorlink_tpu.models import init_params as j_init_params
from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
from tensorlink_tpu_torch.engine import optimizers as topt
from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine.serve_train import ServeTrainLoop
from tensorlink_tpu_torch.engine.training import (
    make_optimizer,
    make_train_step,
)
from tensorlink_tpu_torch.ml.batching import ContinuousBatcher

torch.set_num_threads(1)

JCFG = JModelConfig(
    family="llama", vocab_size=64, d_model=32, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=8, d_ff=64, max_seq_len=64, dtype=jnp.float32,
)
CFG = config_from_jax(dataclasses.asdict(JCFG))
# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=2, page_size=8, chunk_steps=2, prefill_chunk=8)
# tlint: disable=TL006(read-only constant table)
PROMPTS = ([1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1, 60], [33] * 12)


@pytest.fixture(scope="module")
def tiny():
    jp = jax.device_get(j_init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def _batcher(params):
    return ContinuousBatcher(
        engine=GenerationEngine(CFG, params, max_seq_len=64, device="cpu"),
        eos_ids=[], kv_quant="none", **ENGINE_KW)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, JCFG.vocab_size, (2, 16)).astype(np.int32)
            for _ in range(n)]


def test_serve_train_loop_requires_local_engine(tiny):
    _, params = tiny

    class NotLocal:
        _cont = None

    ts = make_train_step(CFG, make_optimizer("adamw", lr=1e-3))
    with pytest.raises(ValueError, match="local"):
        ServeTrainLoop(NotLocal(), ts, params, data_fn=lambda i: None)


def test_serve_train_loop_gating_and_cadence():
    """Tick mechanics against fakes: yields while foreground work exists,
    steps otherwise, publishes every publish_every steps, stops at
    max_steps, detaches when done."""

    class FakeCont:
        def __init__(self):
            self.fg = False
            self.published = []
            self.noted = []
            self.weights_version = 1

        def foreground_work(self, above="best_effort"):
            return self.fg

        def note_train_step(self, ms, mfu=0.0):
            self.noted.append((ms, mfu))

        def publish_weights(self, params, version=None):
            self.weights_version += 1
            self.published.append(self.weights_version)
            return self.weights_version

    class FakeBatcher:
        def __init__(self):
            self._cont = FakeCont()
            self.bg = "unset"

        def set_background(self, fn):
            self.bg = fn

    class FakeStep:
        mode = "unsharded"

        def init_state(self, params):
            return {}

        def step_fn(self, p, s, b):
            return p, s, {"loss": torch.tensor(1.0)}

    bat = FakeBatcher()
    pubs = []
    loop = ServeTrainLoop(
        bat, FakeStep(), {"w": torch.zeros(2)},
        data_fn=lambda i: {"tokens": torch.zeros((2, 4), dtype=torch.int32)},
        publish_every=2, max_steps=5,
        on_publish=lambda v, p: pubs.append(v),
    ).attach()
    assert callable(bat.bg) and bat.bg.__self__ is loop
    bat._cont.fg = True
    assert loop.tick() is False and loop.step == 0  # yielded
    bat._cont.fg = False
    for _ in range(10):
        loop.tick()
    assert loop.step == 5 and loop.done
    assert bat._cont.published == [2, 3]  # steps 2 and 4
    assert pubs == [2, 3]
    assert len(bat._cont.noted) == 5
    assert bat.bg is None  # detached at max_steps
    assert loop.tick() is False  # done stays done


def test_serve_and_train_loop_end_to_end(tiny):
    """The trainer trains and publishes while a best_effort stream
    decodes: the stream runs to its full length, the telemetry flows, and
    the loop stops at max_steps."""
    _, params = tiny
    bat = _batcher(params)
    try:
        ts = make_train_step(CFG, make_optimizer("adamw", lr=1e-3))
        data = _data(4)
        loop = ServeTrainLoop(
            bat, ts, params,
            data_fn=lambda i: {"tokens": torch.as_tensor(data[i])},
            publish_every=2, max_steps=4, cfg=CFG, peak_flops=1e12,
        ).attach()
        out = bat.generate([1, 2, 3], max_new_tokens=30,
                           priority="best_effort", timeout=120)
        deadline = time.monotonic() + 60
        while not loop.done and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(out) == 30
        assert loop.done and loop.step == 4 and loop.publishes == 2
        st = bat._cont.serving_snapshot()
        assert st["train_steps"] == 4 and st["weights_published"] == 2
        assert st["weights_version"] == 3
        assert st["train_step_ms"] > 0 and st["train_mfu"] > 0
    finally:
        bat.close()


def test_published_tree_and_streams_equal_jax(tiny):
    jp, params = tiny
    data = _data(4, seed=5)
    jts = jtrain.make_train_step(
        JCFG, jtrain.make_optimizer("sgd", lr=0.1, momentum=0.9),
        donate=False)
    jparams, jstate = jp, jts.init_state(jp)
    for toks in data:
        jparams, jstate, _ = jts.step_fn(jparams, jstate,
                                         {"tokens": jnp.asarray(toks)})
    jce = JEngine(JGen(JCFG, jparams, seq_buckets=(16,), batch_buckets=(1,),
                       max_seq_len=64), **ENGINE_KW)
    jreqs = [jce.submit(list(p), max_new_tokens=12, seed=0) for p in PROMPTS]
    jce.run_until_idle()

    bat = _batcher(params)
    try:
        ts = make_train_step(CFG, make_optimizer("sgd", lr=0.1,
                                                 momentum=0.9))
        loop = ServeTrainLoop(
            bat, ts, params,
            data_fn=lambda i: ({"tokens": torch.as_tensor(data[i])}
                               if i < len(data) else None),
            publish_every=2,
        ).attach()
        deadline = time.monotonic() + 60
        while not loop.done and time.monotonic() < deadline:
            time.sleep(0.02)
        assert loop.done and loop.step == 4 and loop.publishes == 2
        published = bat._cont.engine.params
        got = [t.numpy() for t in topt.tree_leaves(published)]
        want = [np.asarray(x) for x in jax.tree.leaves(jparams)]
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6)
        outs = [bat.generate(list(p), max_new_tokens=12,
                             priority="interactive") for p in PROMPTS]
        assert outs == [list(r.tokens) for r in jreqs]
    finally:
        bat.close()

"""Fleet serving and control-plane recovery in the port against the JAX
package on the same inputs.

- Router and autopilot decisions: both packages' ``FleetRouter`` and
  ``FleetAutopilot`` are fed the same fake batchers and actions (the
  fakes of tests/test_fleet.py) and give equal route picks, scores,
  admission answers, failover results and action sequences — exactly,
  since the arithmetic is the same Python. Views drawn from a numpy seed
  add cases the hand-written scenarios do not reach.
- An in-process fleet: two port ``ContinuousEngine`` replicas under
  ``EngineFleetActions`` beside a fleet of two JAX engines, on the same
  weights. Greedy fleet dispatch streams are token-equal to JAX's; a
  rebalance that page-ships a live stream and a rolling deploy under a
  live stream give the unmoved stream token for token (the JAX engine's
  too), with zero streams dropped and pages conserved.
- Recovery's plan: the same control journal (two hosted replicas, an
  open ``mig`` ticket, an open deploy action) is replayed by both
  packages' validators over a recording fake bridge; ``recover()``'s
  summaries, the journal's closing records, the re-queued deploy and
  the bridge calls (which workers got an ``expire_migrations``) are
  equal.
- The validator's fleet surfaces (``/healthz`` headroom per replica, a
  dead replica reported unroutable, ``/fleet``, ``/stats``, the
  ``/metrics`` label groups) equal the JAX validator's over the same
  fake replicas.
"""

import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.engine import scheduler as jsched
from tensorlink_tpu.engine.paged import prompt_chain_hashes as j_chain_hashes
from tensorlink_tpu.fleet import autopilot as jauto
from tensorlink_tpu.fleet import router as jrouter
from tensorlink_tpu_torch.engine import scheduler as tsched
from tensorlink_tpu_torch.engine.paged import (
    prompt_chain_hashes as t_chain_hashes,
)
from tensorlink_tpu_torch.fleet import autopilot as tauto
from tensorlink_tpu_torch.fleet import router as trouter

torch.set_num_threads(1)

# tlint: disable=TL006(read-only package table)
PKGS = {
    "jax": types.SimpleNamespace(
        FleetRouter=jrouter.FleetRouter, FleetAutopilot=jauto.FleetAutopilot,
        NoReplicaAvailable=jrouter.NoReplicaAvailable,
        SchedulerOverloaded=jsched.SchedulerOverloaded,
        chain_hashes=j_chain_hashes),
    "port": types.SimpleNamespace(
        FleetRouter=trouter.FleetRouter, FleetAutopilot=tauto.FleetAutopilot,
        NoReplicaAvailable=trouter.NoReplicaAvailable,
        SchedulerOverloaded=tsched.SchedulerOverloaded,
        chain_hashes=t_chain_hashes),
}


# -- fakes (tests/test_fleet.py's, copied) --------------------------------
def _view(**kw):
    base = {
        "draining": False,
        "worker_role": "mixed",
        "max_slots": 4,
        "slots_free": 4,
        "kv_pages_free": 32,
        "kv_pages_total": 32,
        "service_ewma_s": 0.5,
        "queue_depth": {"interactive": 0, "batch": 0, "best_effort": 0},
        "prefix_digest": {},
    }
    base.update(kw)
    return base


class FakeBatcher:
    """router_snapshot/admission_check/generate triple the router needs."""

    def __init__(self, view=None, tokens=(1, 2, 3), fail=None, reject=None):
        self.view = view or _view()
        self.tokens = list(tokens)
        self.fail = fail  # exception to raise from generate
        self.reject = reject  # admission_check rejection record
        self.calls = 0

    def router_snapshot(self):
        return dict(self.view)

    def admission_check(self, priority=None, n=1):
        return dict(self.reject) if self.reject else None

    def generate(self, ids, *, max_new_tokens, stream_cb=None, **kw):
        self.calls += 1
        if self.fail is not None:
            raise self.fail
        if stream_cb is not None:
            for t in self.tokens:
                stream_cb([t])
        return list(self.tokens)


class MidStream(FakeBatcher):
    """Streams one token, then dies."""

    def generate(self, ids, *, max_new_tokens, stream_cb=None, **kw):
        self.calls += 1
        stream_cb([1])
        raise RuntimeError("died mid-stream")


class FakeActions:
    def __init__(self, remaining=(0,)):
        self.calls: list = []
        self._remaining = list(remaining)
        self.rehost_handle = FakeBatcher(_view())

    def rebalance(self, src, dst, k):
        self.calls.append(("rebalance", src, dst, k))
        return k

    def drain(self, rid):
        self.calls.append(("drain", rid))

    def undrain(self, rid):
        self.calls.append(("undrain", rid))

    def drain_step(self, src, dst, max_streams=4):
        self.calls.append(("drain_step", src, dst))
        return self._remaining.pop(0) if self._remaining else 0

    def rehost(self, rid):
        self.calls.append(("rehost", rid))
        return self.rehost_handle

    def scale_decode(self, up):
        self.calls.append(("scale", up))
        return True


def _digest_for(P, tokens, page_size):
    """A digest covering every full-page prefix of ``tokens``."""
    hs = P.chain_hashes(tokens, page_size, 64)
    return {
        "page_size": page_size,
        "chains": {h: (i + 1) * page_size for i, h in enumerate(hs)},
    }


def _router(P, batchers: dict, **kw):
    r = P.FleetRouter(refresh_s=0.0, **kw)
    for rid, b in batchers.items():
        r.register(rid, b)
    return r


def _snap(r) -> dict:
    s = r.snapshot()
    for v in s["replicas"].values():
        v.pop("cooling", None)  # wall-clock dependent
    return s


def _records(recs):
    return [{k: v for k, v in rec.items() if k != "t"} for rec in recs]


# -- router scenarios: each returns what it observed ---------------------
def r_affinity(P):
    prompt = list(range(1, 17))
    warm = FakeBatcher(_view(prefix_digest=_digest_for(P, prompt, 4)))
    cold = FakeBatcher(_view())
    r = _router(P, {"warm": warm, "cold": cold})
    out = [r.route(prompt), r.route(list(range(40, 50))),
           r.cache_affinity(cold.view, prompt),
           r.cache_affinity(warm.view, prompt),
           r.cache_affinity(warm.view, prompt[:9] + [99] * 8),
           r.score(warm.view, prompt, "interactive"),
           r.score(cold.view, prompt, "batch", inflight=2)]
    assert out[0] == "warm" and out[3] == 16
    return out + [_snap(r)]


def r_host_tier_affinity(P):
    prompt = list(range(3, 27))
    hbm = _digest_for(P, prompt[:8], 8)
    host = _digest_for(P, prompt, 8)
    view = _view(prefix_digest=hbm, host_tier_digest=host)
    only_host = _view(host_tier_digest=host)
    r = _router(P, {"a": FakeBatcher(view), "b": FakeBatcher(only_host)})
    return [r.cache_affinity(view, prompt), r.cache_affinity(only_host, prompt),
            r.route(prompt)]


def r_load_overrides(P):
    prompt = list(range(1, 17))
    warm = FakeBatcher(_view(
        prefix_digest=_digest_for(P, prompt, 4),
        queue_depth={"interactive": 40, "batch": 0, "best_effort": 0},
        service_ewma_s=2.0, slots_free=0,
    ))
    r = _router(P, {"warm": warm, "idle": FakeBatcher(_view())})
    out = [r.route(prompt, priority="interactive"),
           r.route(prompt, priority="batch")]
    assert out[0] == "idle"
    return out


def r_fences(P):
    r = _router(P, {"a": FakeBatcher(_view(draining=True)),
                    "b": FakeBatcher(_view(worker_role="decode")),
                    "c": FakeBatcher(_view())})
    solo = _router(P, {"only": FakeBatcher(_view(draining=True))})
    out = [r.route([1, 2, 3]), solo.route([1, 2, 3]),
           r.route([1, 2, 3], exclude={"c"})]
    assert out[:2] == ["c", "only"]
    return out


def r_failover(P):
    r = _router(P, {"bad": FakeBatcher(_view(),
                                       fail=RuntimeError("replica died")),
                    "good": FakeBatcher(_view(worker_role="decode"))},
                failure_cooldown_s=0.1)
    out = [r.route([1]), r.dispatch([1], max_new_tokens=4), _snap(r)]
    got: list = []
    r2 = _router(P, {"mid": MidStream(_view()),
                     "other": FakeBatcher(_view(worker_role="decode"))})
    out += [r2.dispatch([1], max_new_tokens=4,
                        stream_cb=lambda t: got.append(t)), list(got)]
    r3 = _router(P, {"mid": MidStream(_view()),
                     "other": FakeBatcher(_view(worker_role="decode"))})
    with pytest.raises(RuntimeError, match="mid-stream"):
        r3.dispatch([1], max_new_tokens=4, temperature=0.7,
                    stream_cb=lambda t: None)
    assert out[1] == [1, 2, 3] and out[4] == [[1], [2], [3]]
    return out + [_snap(r2), _snap(r3)]


def r_overflow(P):
    rej = {"priority": "interactive", "queue_depth": 9, "cap": 8,
           "retry_after": 5.0}
    full = FakeBatcher(_view(), reject=rej)
    full.fail = P.SchedulerOverloaded("interactive", 9, 8, 5.0)
    open_ = FakeBatcher(_view(worker_role="decode"))
    r = _router(P, {"full": full, "open": open_})
    out = [r.admission_check("interactive"),
           r.dispatch([1], max_new_tokens=4), _snap(r)]
    open_.reject = {**rej, "retry_after": 2.0}
    out.append(r.admission_check("interactive"))
    drained = _router(P, {"d": FakeBatcher(_view(draining=True), reject=rej),
                          "e": FakeBatcher(_view(draining=True))})
    out.append(drained.admission_check("batch"))
    assert out[3]["retry_after"] == 2.0
    return out


def r_empty(P):
    r = P.FleetRouter(refresh_s=0.0)
    out = [r.route([1])]
    with pytest.raises(P.NoReplicaAvailable):
        r.dispatch([1], max_new_tokens=1)
    b = FakeBatcher(_view())
    r.register("a", b)
    out += [r.deregister("a") is b, r.route([1]), len(r)]
    r.register("a", b)
    r.register("a", b)  # a rejoin bumps the generation
    r.seed_state({"routed": {"a": 5, "zz": 3}, "generation": {"a": 4}})
    return out + [_snap(r), r.export_state()]


def r_seeded_views(P):
    """Views drawn from a numpy seed: every score and the pick per
    (prompt, class), with inflight counts accumulating across routes."""
    rng = np.random.default_rng(1234)
    prompts = [list(map(int, rng.integers(0, 200, n)))
               for n in (5, 16, 24, 40)]
    batchers = {}
    for i in range(5):
        dig = (_digest_for(P, prompts[rng.integers(0, 4)][:16],
                           int(rng.choice([4, 8])))
               if rng.random() < 0.6 else {})
        batchers[f"r{i}"] = FakeBatcher(_view(
            slots_free=int(rng.integers(0, 5)),
            service_ewma_s=float(rng.uniform(0.05, 3.0)),
            queue_depth={c: int(rng.integers(0, 9))
                         for c in ("interactive", "batch", "best_effort")},
            worker_role=str(rng.choice(["mixed", "prefill", "decode"])),
            draining=bool(rng.random() < 0.2),
            prefix_digest=dig,
        ))
    r = _router(P, batchers)
    out = []
    for p in prompts:
        for cls in ("interactive", "batch", "best_effort", None):
            out.append([r.score(b.view, p, cls or "interactive", inflight=k)
                        for k, b in enumerate(batchers.values())])
            out.append(r.route(p, priority=cls))
            out.append(r.admission_check(cls))
    return out + [_snap(r)]


# tlint: disable=TL006(read-only scenario table)
ROUTER_SCENARIOS = {
    f.__name__[2:]: f for f in (
        r_affinity, r_host_tier_affinity, r_load_overrides, r_fences,
        r_failover, r_overflow, r_empty, r_seeded_views,
    )
}


@pytest.mark.parametrize("scenario", list(ROUTER_SCENARIOS))
def test_router_decisions_equal_jax(scenario):
    f = ROUTER_SCENARIOS[scenario]
    assert f(PKGS["port"]) == f(PKGS["jax"])


# -- autopilot scenarios ---------------------------------------------------
def _fleet(P, views: dict):
    return _router(P, {rid: FakeBatcher(v) for rid, v in views.items()})


def a_rebalance(P):
    r = _fleet(P, {
        "hot": _view(slots_free=0,
                     queue_depth={"interactive": 6, "batch": 0,
                                  "best_effort": 0}),
        "cold": _view(),
    })
    acts = FakeActions()
    ap = P.FleetAutopilot(r, acts, action_cooldown_s=0.0,
                          rebalance_spread=0.5, max_moves_per_tick=2)
    out = [_records(ap.tick()), acts.calls]
    acts2 = FakeActions()
    out.append(_records(P.FleetAutopilot(
        _fleet(P, {"a": _view(), "b": _view()}), acts2,
        action_cooldown_s=0.0).tick()))
    acts3 = FakeActions()
    out.append(_records(P.FleetAutopilot(
        _fleet(P, {"only": _view(slots_free=0)}), acts3,
        action_cooldown_s=0.0).tick()))
    assert ("rebalance", "hot", "cold", 2) in acts.calls
    return out + [acts2.calls, acts3.calls]


def a_cooldown_dry_run(P):
    r = _fleet(P, {"hot": _view(slots_free=0), "cold": _view()})
    acts = FakeActions()
    ap = P.FleetAutopilot(r, acts, action_cooldown_s=3600.0,
                          rebalance_spread=0.5)
    ap._last_action_t = time.monotonic()  # an action just happened
    out = [_records(ap.tick())]
    dry = P.FleetAutopilot(r, acts, action_cooldown_s=0.0,
                           rebalance_spread=0.5, dry_run=True)
    out += [_records(dry.tick()), acts.calls]
    assert out[1][0]["dry_run"] is True and acts.calls == []
    return out


def a_deploy(P):
    r = _fleet(P, {"a": _view(), "b": _view()})
    acts = FakeActions(remaining=[2, 0])
    journal: list = []

    def hook(phase, kind, rid, token=None):
        journal.append((phase, kind, rid, token))
        return f"iid-{len(journal)}" if phase == "intent" else token

    ap = P.FleetAutopilot(r, acts, action_cooldown_s=0.0, on_action=hook)
    out = [ap.request_deploy(["a"])]
    for _ in range(4):
        out.append(_records(ap.tick()))
    st = ap.status()
    out += [acts.calls, journal, r.batcher("a") is acts.rehost_handle,
            _snap(r)["replicas"]["a"]["generation"], st["deploying"],
            st["deploy_queue"], _records(st["history"])]
    assert out[3][0]["kind"] == "deploy_done"
    return out


def a_deploy_skip_and_last(P):
    r = _fleet(P, {"a": _view(), "b": _view()})
    acts = FakeActions()
    ap = P.FleetAutopilot(r, acts, action_cooldown_s=0.0)
    out = [ap.request_deploy(["typo", "a"]), _records(ap.tick()),
           _records(ap.tick())]
    solo = P.FleetAutopilot(_fleet(P, {"only": _view()}), FakeActions(),
                            action_cooldown_s=0.0)
    solo.request_deploy(["only"])
    out += [_records(solo.tick()), solo.actions.calls, acts.calls]
    assert out[1][0]["kind"] == "deploy_skipped"
    return out


def a_deploy_all(P):
    """request_deploy(None) walks every replica, one at a time."""
    r = _fleet(P, {"a": _view(), "b": _view(), "c": _view()})
    acts = FakeActions(remaining=[0, 0, 0])
    ap = P.FleetAutopilot(r, acts, action_cooldown_s=0.0)
    out = [ap.request_deploy()]
    for _ in range(7):
        out.append(_records(ap.tick()))
    return out + [acts.calls]


def a_decode_watermarks(P):
    out = []
    for views in (
        {"p": _view(worker_role="prefill"),
         "d": _view(worker_role="decode", slots_free=0)},
        {"p": _view(worker_role="prefill"),
         "d": _view(worker_role="decode", slots_free=4)},
        {"d": _view(worker_role="decode", slots_free=2)},
    ):
        acts = FakeActions()
        ap = P.FleetAutopilot(_fleet(P, views), acts, action_cooldown_s=0.0,
                              decode_low_water=0.25, decode_high_water=0.75)
        out += [_records(ap.tick()), acts.calls]
    assert ("scale", True) in out[1] and ("scale", False) in out[3]
    return out


def a_seeded_ticks(P):
    """Ticks over views drawn from a numpy seed and a FakeActions whose
    drain rounds come from the same seed."""
    rng = np.random.default_rng(99)
    out = []
    for _ in range(6):
        views = {
            f"r{i}": _view(
                slots_free=int(rng.integers(0, 5)),
                queue_depth={c: int(rng.integers(0, 6))
                             for c in ("interactive", "batch", "best_effort")},
                worker_role=str(rng.choice(["mixed", "mixed", "decode"])),
            )
            for i in range(int(rng.integers(2, 5)))
        }
        acts = FakeActions(remaining=list(map(int, rng.integers(0, 3, 3))))
        ap = P.FleetAutopilot(
            _fleet(P, views), acts, action_cooldown_s=0.0,
            rebalance_spread=float(rng.uniform(0.2, 1.0)),
            max_moves_per_tick=int(rng.integers(1, 4)))
        if rng.random() < 0.5:
            ap.request_deploy(["r0"])
        for _ in range(4):
            out.append(_records(ap.tick()))
        out.append(acts.calls)
    return out


# tlint: disable=TL006(read-only scenario table)
AUTOPILOT_SCENARIOS = {
    f.__name__[2:]: f for f in (
        a_rebalance, a_cooldown_dry_run, a_deploy, a_deploy_skip_and_last,
        a_deploy_all, a_decode_watermarks, a_seeded_ticks,
    )
}


@pytest.mark.parametrize("scenario", list(AUTOPILOT_SCENARIOS))
def test_autopilot_decisions_equal_jax(scenario):
    f = AUTOPILOT_SCENARIOS[scenario]
    assert f(PKGS["port"]) == f(PKGS["jax"])


# -- an in-process fleet over real engines ---------------------------------
@pytest.fixture(scope="module")
def engines():
    """The same tiny f32 weights in a JAX and a port GenerationEngine."""
    from tensorlink_tpu.engine.generate import GenerationEngine as JGen
    from tensorlink_tpu.models import ModelConfig as JModelConfig
    from tensorlink_tpu.models import init_params as j_init_params
    from tensorlink_tpu_torch.convert import config_from_jax, params_from_jax
    from tensorlink_tpu_torch.engine.generate import GenerationEngine

    jcfg = JModelConfig(
        family="llama", vocab_size=128, d_model=32, n_layers=2, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, max_seq_len=64,
        dtype=jnp.float32, tie_embeddings=False,
    )
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jgen = JGen(jcfg, jparams, seq_buckets=(8, 32), batch_buckets=(1,),
                max_seq_len=64)
    tgen = GenerationEngine(cfg, tparams, max_seq_len=64, device="cpu")
    return {"jax": jgen, "port": tgen}


# tlint: disable=TL006(read-only constant table)
ENGINE_KW = dict(max_slots=4, page_size=8, chunk_steps=4)


def _pkg_fleet(pkg):
    if pkg == "jax":
        from tensorlink_tpu.engine.continuous import ContinuousEngine
        from tensorlink_tpu.fleet import EngineFleetActions, FleetAutopilot
        from tensorlink_tpu.fleet import FleetRouter
        from tensorlink_tpu.ml.batching import ContinuousBatcher
    else:
        from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
        from tensorlink_tpu_torch.fleet import EngineFleetActions
        from tensorlink_tpu_torch.fleet import FleetAutopilot, FleetRouter
        from tensorlink_tpu_torch.ml.batching import ContinuousBatcher
    return types.SimpleNamespace(
        ContinuousEngine=ContinuousEngine,
        EngineFleetActions=EngineFleetActions, FleetAutopilot=FleetAutopilot,
        FleetRouter=FleetRouter, ContinuousBatcher=ContinuousBatcher)


def _local_batcher(F, eng):
    return F.ContinuousBatcher(engine=F.ContinuousEngine(eng, **ENGINE_KW),
                               eos_ids=[])


def _solo(F, eng, prompt, n):
    ce = F.ContinuousEngine(eng, **ENGINE_KW)
    req = ce.submit(prompt, max_new_tokens=n, seed=0)
    ce.run_until_idle()
    out = list(req.tokens)
    ce.close()
    return out


def _mk_fleet(F, eng, n=2):
    batchers = {f"r{i}": _local_batcher(F, eng) for i in range(n)}
    router = F.FleetRouter(refresh_s=0.0)
    for rid, b in batchers.items():
        router.register(rid, b)
    actions = F.EngineFleetActions(
        lambda rid: router.batcher(rid)._cont,
        exec_on=lambda rid, fn: router.batcher(rid).run_on_driver(fn),
        rebuild=lambda rid: _local_batcher(F, eng),
    )
    return batchers, router, actions


def _await_movable(actions, rid, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if actions.movable_streams(rid) >= 1:
            return
        time.sleep(0.005)
    raise AssertionError(f"no movable stream ever appeared on {rid}")


def _fleet_dispatch(pkg, eng):
    F = _pkg_fleet(pkg)
    batchers, router, _ = _mk_fleet(F, eng)
    prompts = [[1 + i, 2, 3, 4 + i] for i in range(6)]
    results: dict = {}
    try:
        def one(i):
            results[i] = router.dispatch(prompts[i], max_new_tokens=8)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        snap = router.snapshot()
        assert sum(r["routed"] for r in snap["replicas"].values()) == 6
        solos = [_solo(F, eng, p, 8) for p in prompts]
        assert [results.get(i) for i in range(6)] == solos
        return solos
    finally:
        for b in batchers.values():
            b.close()


def test_fleet_dispatch_streams_equal_jax(engines):
    """Concurrent greedy dispatches through each package's router: every
    stream equals its solo run, and the port's equal JAX's."""
    assert _fleet_dispatch("port", engines["port"]) == _fleet_dispatch(
        "jax", engines["jax"])


def _moved_stream(pkg, eng, how: str):
    """One live greedy stream on r0, moved off it mid-decode by a
    rebalance or by a rolling deploy of r0; returns (moved, solo)."""
    F = _pkg_fleet(pkg)
    batchers, router, actions = _mk_fleet(F, eng)
    ap = F.FleetAutopilot(router, actions, action_cooldown_s=0.0,
                          max_moves_per_tick=4)
    prompt, budget = [5, 4, 3, 2, 1, 1, 2, 3, 4], 48
    out: dict = {}
    try:
        def client():
            out["tokens"] = batchers["r0"].generate(
                prompt, max_new_tokens=budget, temperature=0.0)

        t = threading.Thread(target=client)
        t.start()
        _await_movable(actions, "r0")
        if how == "rebalance":
            assert actions.rebalance("r0", "r1", 1) == 1
        else:
            ap.request_deploy(["r0"])
            for _ in range(20):
                if any(r["kind"] == "deploy_done" for r in ap.tick()):
                    break
            else:
                raise AssertionError(f"deploy never finished: {ap.status()}")
        t.join(timeout=120)
        assert "tokens" in out, "the moved stream never finished"
        # pages conserved on every replica; the move adopted on r1
        for rid in ("r0", "r1"):
            router.batcher(rid).run_on_driver(
                lambda e: e.check_page_conservation())
        adopted = batchers["r1"].run_on_driver(
            lambda e: int(e.stats["migrations_adopted"]))
        assert adopted == 1
        if how == "deploy":
            nb = router.batcher("r0")
            assert nb is not batchers["r0"]
            assert nb.generate([2, 2, 2], max_new_tokens=4) == _solo(
                F, eng, [2, 2, 2], 4)
            nb.close()
        return out["tokens"], _solo(F, eng, prompt, budget)
    finally:
        ap.stop()
        for b in batchers.values():
            b.close()


@pytest.mark.parametrize("how", ["rebalance", "deploy"])
def test_moved_live_stream_equals_unmoved_and_jax(engines, how):
    """A rebalance page-ships the live stream to r1; a rolling deploy of
    r0 drains it there and rebuilds r0. Either way the client's stream
    is the unmoved one token for token, in both packages, and the port's
    equals JAX's."""
    moved, solo = _moved_stream("port", engines["port"], how)
    assert moved == solo
    jmoved, jsolo = _moved_stream("jax", engines["jax"], how)
    assert jmoved == jsolo
    assert moved == jmoved


# -- recovery's plan against the JAX package's --------------------------
class _RecordingBridge:
    """The validator's bridge and node RPCs: every call recorded, canned
    answers for the verbs recovery sends."""

    def __init__(self, workers: dict, orphans: dict):
        self.workers = workers  # wid -> [host, port]
        self.orphans = orphans  # wid -> orphan report of its attach ack
        self.calls: list = []
        self.conns: dict = {}

    def request(self, verb, payload=None, timeout=None):
        p = payload or {}
        if verb == "connect":
            self.calls.append((verb, p["host"], p["port"]))
            return f"conn:{p['port']}"
        if verb == "tensor_request":
            body = p["body"]
            wid = next(w for w, c in self.conns.items() if c == p["peer"])
            self.calls.append((verb, wid, p["tag"],
                               bool(body.get("attach_only"))))
            return {"job_id": body["job_id"], "ok": True, "attached": True,
                    "n_layers": 2, "live_slots": 1,
                    "orphans": self.orphans.get(wid, [])}
        if verb == "expire_migrations":
            self.calls.append((verb, p["worker"], p.get("job_id")))
            return {"ok": True, "expired": 2 if p["worker"] == "w-dst" else 0}
        if verb == "stats_workers":
            self.calls.append((verb,))
            return [{"id": w, "addr": a} for w, a in self.workers.items()]
        self.calls.append((verb, json_safe(p)))
        return {"ok": True}

    def connect_to(self, host, port):
        cid = f"conn:{port}"
        wid = next(w for w, a in self.workers.items() if a[1] == port)
        self.conns[wid] = cid
        return cid


def json_safe(p):
    return {k: v for k, v in sorted(p.items())}


def _journal_and_recover(pkg, tmp):
    if pkg == "jax":
        from tensorlink_tpu.core import config as C
        from tensorlink_tpu.core.journal import ControlJournal
        from tensorlink_tpu.ml.validator import DistributedValidator
    else:
        from tensorlink_tpu_torch.core import config as C
        from tensorlink_tpu_torch.core.journal import ControlJournal
        from tensorlink_tpu_torch.ml.validator import DistributedValidator
    from tensorlink_tpu_torch.models.base import ModelConfig
    from tensorlink_tpu_torch.parallel.planner import (
        WorkerCapacity,
        plan_sharding,
    )

    mcfg = ModelConfig(family="llama", vocab_size=258, d_model=32,
                       n_layers=2, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=64, max_seq_len=64, dtype=torch.float32)
    workers = {"w-a": ["127.0.0.1", 7001], "w-b": ["127.0.0.1", 7002],
               "w-dst": ["127.0.0.1", 7003]}
    spec = {"name": "fleet-tiny", "seed": 0, "config": mcfg.to_json()}

    def attach(jid, wid):
        plan = plan_sharding(mcfg, [WorkerCapacity(node_id=wid,
                                                   hbm_bytes=8e9)],
                             model_name="fleet-tiny", seq_len=64)
        return {"job_id": jid, "model": spec, "workers": {wid: workers[wid]},
                "serving_roles": {wid: "mixed"}, "plan": plan.to_json()}

    # the journal a crashed fleet validator left: a hosted model with two
    # replicas, three admissions (one finished), an open drain ticket and
    # an open deploy intent
    j = ControlJournal(tmp / "control_journal.jsonl")
    iid = j.intent("host", {"name": "fleet-tiny", "spec": spec, "batch": 1,
                            "seed": 0, "seq_len": 64})
    for rid, jid, wid in (("r0", "job0", "w-a"), ("r1", "job1", "w-b")):
        j.append("replica_up", {"name": "fleet-tiny", "rid": rid,
                                "job_id": jid, "attach": attach(jid, wid),
                                "spec": spec, "batch": 1, "seed": 0,
                                "seq_len": 64}, flush=True)
    j.commit(iid, {"replicas": 2})
    for jrid, rid, n in (("s1", "r0", 16), ("s2", "r1", 0), ("s3", "r0", 4)):
        j.append("admit", {"jrid": jrid, "model": "fleet-tiny",
                           "prompt_sha": "ab", "n_prompt": 5, "priority": "",
                           "max_new_tokens": 40, "placement": "router"})
        j.append("place", {"jrid": jrid, "rid": rid})
        j.append("seed", {"jrid": jrid, "seed": 7})
        if n:
            j.append("hwm", {"jrid": jrid, "n": n})
    j.append("finish", {"jrid": "s3", "n": 9, "reason": "length"})
    mig = j.intent("mig", {"name": "fleet-tiny", "rid": "r0", "src": "w-a",
                           "dest": "w-dst", "job_id": "job0",
                           "src_addr": workers["w-a"],
                           "dest_addr": workers["w-dst"]})
    act = j.intent("action", {"verb": "deploy", "rid": "r0",
                              "name": "fleet-tiny"})
    stale = j.intent("action", {"verb": "rebalance", "rid": "r1",
                                "name": "fleet-tiny"})
    j.close()

    bridge = _RecordingBridge(workers, orphans={
        "w-a": [{"jrid": "s1", "n": 23, "finished": False}],
        "w-b": [{"jrid": "s2", "n": 40, "finished": True}],
    })
    ml = C.MLConfig(fleet_autopilot=True, fleet_autopilot_interval_s=3600.0)
    node = types.SimpleNamespace(
        bridge=bridge, send_request=bridge.request,
        connect_to=bridge.connect_to,
        config=C.ValidatorConfig(log_dir=str(tmp), ml=ml))
    v = DistributedValidator(node)
    try:
        info = v.recover()
        job = v.hosted["fleet-tiny"]
        status = job.autopilot.status()
        replay = ControlJournal.replay(tmp / "control_journal.jsonl")
        closes = {k: (replay.intents[i]["state"],
                      replay.intents[i]["close_data"])
                  for k, i in (("mig", mig), ("deploy", act),
                               ("rebalance", stale))}
        return {
            "info": info,
            "replicas": [r["rid"] for r in job.replicas],
            "job_ids": [r["job_id"] for r in job.replicas],
            "router": job.router.export_state(),
            "deploy_queue": status["deploy_queue"],
            "closes": closes,
            "recovered": replay.recovered,
            "bridge": bridge.calls,
            "fleet": sorted(v.fleet_snapshot()),
        }
    finally:
        for name in list(v.hosted):
            v.unhost_model(name)
        if v.journal is not None:
            v.journal.close()


def test_recovery_plan_equals_jax(tmp_path):
    """Both validators re-attach the same replicas (attach_only MODULE
    frames to the plan workers), reconcile the same streams (worker
    counts raise the journaled marks), expire the open ticket at both
    endpoints, re-queue the interrupted deploy and drop the stale
    rebalance intent."""
    port = _journal_and_recover("port", tmp_path / "port")
    jx = _journal_and_recover("jax", tmp_path / "jax")
    assert port == jx
    info = port["info"]
    assert info["jobs"] == {"fleet-tiny": {"status": "ready", "replicas": 2}}
    assert info["expired_migrations"] == 2 and info["requeued_deploys"] == 1
    assert port["deploy_queue"] == ["r0"]
    assert port["closes"]["mig"][0] == "abort"
    assert port["closes"]["mig"][1]["recovery"] == "expired"
    assert port["closes"]["deploy"][1]["recovery"] == "requeued"
    assert port["closes"]["rebalance"][1]["recovery"] == "dropped"
    assert {s["jrid"]: s["worker_n"] for s in info["streams"]} == {
        "s1": 23, "s2": 40}


# -- the validator's fleet surfaces ---------------------------------------
class _ModesBatcher(FakeBatcher):
    metrics = "its registry"  # /metrics renders it under its labels

    def serving_modes(self):
        return {"kv_quant": "int8", "weight_quant": "none",
                "spec_decode": True, "worker_role": "mixed"}

    def headroom(self):
        snap = self.router_snapshot()
        return {k: snap[k] for k in ("slots_free", "kv_pages_free",
                                     "queue_depth", "draining")}

    def stats(self):
        return {"mode": "remote", "served": self.calls}


class _DeadBatcher(_ModesBatcher):
    def headroom(self):
        raise RuntimeError("local engine is closed")


def _surfaces(pkg):
    """/healthz, /fleet, /stats and /metrics label groups of a bare
    validator holding a two-replica fleet (one replica's headroom dead)
    and a single-replica model, as in tests/test_fleet.py."""
    if pkg == "jax":
        from tensorlink_tpu.ml.validator import (
            DistributedValidator,
            HostedJob,
        )
    else:
        from tensorlink_tpu_torch.ml.validator import (
            DistributedValidator,
            HostedJob,
        )
    P = PKGS[pkg]
    v = DistributedValidator.__new__(DistributedValidator)
    v._host_lock = threading.Lock()
    v.hosted = {}
    v.draining = False
    v.recovering = False
    job = HostedJob(name="m", status="ready")
    b0 = _ModesBatcher(_view(slots_free=3, kv_pages_free=17))
    b1 = _ModesBatcher(_view(slots_free=1, kv_pages_free=5))
    job.batcher = b0
    job.replicas = [
        {"rid": "r0", "model": None, "batcher": b0, "job_id": "j0"},
        {"rid": "r1", "model": None, "batcher": b1, "job_id": "j1"},
        {"rid": "r2", "model": None, "batcher": _DeadBatcher(_view()),
         "job_id": "j2"},
    ]
    job.router = _router(P, {"r0": b0, "r1": b1})
    job.router.route([1, 2, 3])
    v.hosted["m"] = job
    solo = HostedJob(name="solo", status="ready")
    solo.batcher = b0
    v.hosted["solo"] = solo
    fleet = v.fleet_snapshot()
    for f in fleet.values():
        for r in f["router"]["replicas"].values():
            r.pop("cooling")
    return {
        "health": v.health_snapshot(),
        "fleet": fleet,
        "stats": v.hosted_snapshot(),
        "metric_labels": [labels for labels, _reg in v.metrics_groups()],
    }


def test_validator_fleet_surfaces_equal_jax():
    port = _surfaces("port")
    assert port == _surfaces("jax")
    hr = port["health"]["headroom"]
    assert hr["m"]["r0"]["slots_free"] == 3 and hr["m"]["r2"]["dead"]
    assert list(hr["solo"]) == ["r0"] and "solo" not in port["fleet"]
    assert port["fleet"]["m"]["replicas"] == 3
    assert {"model": "m", "replica": "r1"} in port["metric_labels"]

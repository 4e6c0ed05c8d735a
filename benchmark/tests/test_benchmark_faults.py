"""The comparison that decides ``correct`` fails what it should.

On the CPU, whole runs of tiny cells skip the look for a card and drive
the rest of a run (set-up, the closed-loop window, the reference over
the sample) with the serving step broken underneath, once for each fault
a one-card serving cell can have: a token altered where it is sampled;
a step that leaves its state unchanged (no KV row written to the pages);
half of the batch left out of the ragged pass; and in a mix that
samples, a sampler that ignores ``top_k``. A run of the program as it
is comes out correct. The cells have no exchange between cards.

On the card (marked ``cuda``), the lower-precision control, the
program's int8 weights and pages, runs each cell at its own size for a
short window and comes out not correct.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def run_tiny(model: str, mix: str, seed: int, **kw) -> dict:
    return harness.run(tiny_cell(model, mix), seed=seed, seconds=1.5,
                       trace=False, device=torch.device("cpu"),
                       t_start=time.monotonic(), **kw)


def alter_greedy_tokens(monkeypatch):
    from tensorlink_tpu_torch.engine import paged

    orig = paged._sample_rows

    def sample(logits, keys, temp, *a):
        tok = orig(logits, keys, temp, *a)
        nxt = (tok + 1) % logits.shape[-1]
        return torch.where(temp > 0, tok, nxt.to(tok.dtype))
    monkeypatch.setattr(paged, "_sample_rows", sample)


def leave_pages_unwritten(monkeypatch):
    from tensorlink_tpu_torch.engine import paged

    monkeypatch.setattr(paged, "_scatter_kv", lambda kv, *a: kv)


def drop_half_the_batch(monkeypatch):
    from tensorlink_tpu_torch.engine import paged

    orig = paged._Whole.ragged

    def ragged(self, blk, *a):
        x = orig(self, blk, *a)
        x[blk.shape[0] // 2:] = 0
        return x
    monkeypatch.setattr(paged._Whole, "ragged", ragged)


def ignore_top_k(monkeypatch):
    from tensorlink_tpu_torch.engine import paged

    orig = paged._sample_rows

    def sample(logits, keys, temp, top_k, *a):
        return orig(logits, keys, temp, torch.zeros_like(top_k), *a)
    monkeypatch.setattr(paged, "_sample_rows", sample)


CASES = [("olmo2", "chat"), ("mixtral", "chat"), ("olmo2", "docqa")]


@pytest.mark.parametrize("model,mix", CASES)
def test_program_as_it_is_is_correct(model, mix):
    out = run_tiny(model, mix, 2**33 + 1)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", [alter_greedy_tokens,
                                   leave_pages_unwritten,
                                   drop_half_the_batch])
@pytest.mark.parametrize("model,mix", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, fault, model, mix):
    fault(monkeypatch)
    out = run_tiny(model, mix, 2**33 + 1)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("model", ["olmo2", "mixtral"])
def test_a_sampler_ignoring_top_k_is_not_correct(monkeypatch, model):
    ignore_top_k(monkeypatch)
    out = run_tiny(model, "chat", 2**33 + 1)
    assert not out["correct"], out["checks"]
    # the sampled tokens fail it: they lie far outside the nucleus
    assert out["gap_stats"]["sampled_mean_gap"] > 0.1


def test_control_serves_int8():
    """The control switch runs the program's int8 weights and pages."""
    from tensorlink_tpu_torch.engine.generate import GenerationEngine

    seen = []
    orig = GenerationEngine.__init__

    def init(self, *a, quant=None, **kw):
        seen.append(quant)
        orig(self, *a, quant=quant, **kw)
    GenerationEngine.__init__ = init
    try:
        out = run_tiny("olmo2", "chat", 9, control=True)
    finally:
        GenerationEngine.__init__ = orig
    assert seen == ["int8+kv"]
    assert out["gap_stats"]["tokens"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mixtral-8x7b-16L.chat",
                                  "olmo2-7b.docqa", "olmo2-7b.chat"])
def test_control_fails_at_the_cells_size(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", "3141592653", "--seconds", "30", "--trace", "0",
         "--control"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out["checks"]

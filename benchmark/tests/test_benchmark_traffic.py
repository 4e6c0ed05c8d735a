"""The traffic generator: seeded, reproducible, and its lengths as each
mix states."""

import json
import statistics
from pathlib import Path

import pytest

from benchmark.generator import Traffic, quantiles, spread

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def first_requests(t: Traffic, rounds: int) -> list:
    return [t.request(c, r) for r in range(rounds) for c in range(t.n)]


@pytest.mark.parametrize("name,vocab,clients", [
    ("chat", 32000, 32), ("chat", 100352, 24), ("docqa", 100352, 24)])
def test_same_seed_same_streams(name, vocab, clients):
    seed = 3_000_000_019  # above 2**31: seeds may exceed 32 signed bits
    a = first_requests(Traffic(mix(name), vocab, clients, seed), 3)
    b = first_requests(Traffic(mix(name), vocab, clients, seed), 3)
    c = first_requests(Traffic(mix(name), vocab, clients, seed + 1), 3)
    assert a == b
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", ["chat", "docqa"])
def test_every_seed_sends_the_same_sizes(name):
    """Seeds deal the same requests out in another order, so a run's work
    does not depend on its seed."""
    def sizes(seed):
        reqs = first_requests(Traffic(mix(name), 32000, 24, seed), 4)
        return sorted((len(r.prompt), r.max_new_tokens, r.greedy,
                       r.think_s) for r in reqs)
    assert sizes(1) == sizes(2**40 + 7)


def test_chat_lengths_as_stated():
    m = mix("chat")
    t = Traffic(m, 32000, 32, 11)
    reqs = first_requests(t, 8)
    prompts = [len(r.prompt) for r in reqs]
    outs = [r.max_new_tokens for r in reqs]
    assert min(prompts) >= 64 and max(prompts) <= 1024
    assert min(outs) >= 16 and max(outs) <= 128
    # lognormal medians of about 300 and 64 tokens
    assert 270 <= statistics.median(prompts) <= 330
    assert 58 <= statistics.median(outs) <= 70
    # half greedy, the rest sampled with the mix's knobs
    greedy = [r for r in reqs if r.greedy]
    assert len(greedy) * 2 == len(reqs)
    assert all(r.knobs == {} for r in greedy)
    assert all(r.knobs == m["sampled"] for r in reqs if not r.greedy)
    assert all(0 <= tok < 32000 for r in reqs for tok in r.prompt)
    # think times spread over a second, a mean of half of it
    thinks = [r.think_s for r in reqs]
    assert 0 < min(thinks) < 0.05 and 0.95 < max(thinks) < 1
    assert statistics.mean(thinks) == pytest.approx(0.5)


def test_chat_system_prompts_shared_by_half():
    m = mix("chat")
    t = Traffic(m, 32000, 32, 5)
    reqs = first_requests(t, 4)
    sys_len = m["system_prefix"]["len"]
    heads = [tuple(r.prompt[:sys_len]) for r in reqs]
    shared = {tuple(s) for s in t._system}
    assert len(shared) == m["system_prefix"]["count"]
    n_shared = sum(h in shared for h in heads)
    assert n_shared * 2 == len(reqs)
    # the shared prompts go to the longest half, so each fits
    assert all(len(r.prompt) > sys_len
               for r, h in zip(reqs, heads) if h in shared)


def test_docqa_sessions_reuse_their_document():
    m = mix("docqa")
    t = Traffic(m, 100352, 24, 9)
    doc_len, asks = m["document"]["len"], m["document"]["asks"]
    for c in range(t.n):
        reqs = [t.request(c, r) for r in range(2 * asks)]
        docs = [tuple(r.prompt[:doc_len]) for r in reqs]
        first = asks - c % asks  # staggered starts
        assert len(set(docs[:first])) == 1
        assert len(set(docs[first:first + asks])) == 1
        assert docs[0] != docs[first]
        for r in reqs:
            q = len(r.prompt) - doc_len
            assert 64 <= q <= 256
            assert 128 <= r.max_new_tokens <= 256
            assert r.greedy and r.think_s == 0
    pre = t.prewarm_prompts()
    assert pre == [t._document(c, 0) for c in range(t.n)]


def test_quantiles_and_spread():
    assert quantiles({"dist": "uniform", "min": 0, "max": 100}, 4) == \
        [12, 38, 62, 88]
    q = quantiles({"dist": "lognormal", "median": 100, "sigma": 1.0,
                   "min": 10, "max": 200}, 5)
    assert q[2] == 100 and q == sorted(q) and q[-1] == 200
    assert spread(0.5, 6) == [False, True, False, True, False, True]
    assert sum(spread(0.25, 8)) == 2

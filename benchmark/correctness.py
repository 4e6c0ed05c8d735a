"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, two samples
of the requests the window finished, drawn from the seed and each always
holding its longest request, go through the plain float32 reference
(``reference/model.py``) over each prompt and its served tokens: one of
the greedy requests and one of the sampled ones. Each served token gets
a gap, how far its reference logit lies below the least logit the
reference would allow there (0 where it is allowed):

- a greedy token: the reference's best logit;
- a sampled token: the least logit of the reference's nucleus under the
  request's ``temperature``, ``top_k`` and ``top_p``: the ``top_k`` best
  tokens, cut where the probability (over the whole vocabulary, at the
  temperature) ranked before a token reaches ``top_p``. That is the
  looser of the two readings of top-p after top-k in use (Hugging Face
  and vLLM take the probabilities over the top-k tokens alone), so a
  sampler under either reading is held to its top-k and its top-p.

The cell's limits file (``limits/<cell>.json``) names each gap statistic
compared and its limit; the readings each limit was set from are kept
beside it there and in PERF.md.

The statistic compared is a mean gap over every checked token, greedy
and sampled together. The widest gap does not separate the program from
the lower-precision control in every cell: with seeded weights, a MoE
router's choice of experts is near a tie at many tokens, and a bf16
rounding that flips it moves the token's logits as far as an int8 one
does. So Mixtral's, ``clear_mean_gap``, is taken over the served tokens
whose reference router margin (``reference.model._moe``: the gap
between the ``k``-th and the ``(k+1)``-th router logit, least over the
layers) is at least the limits file's ``router_margin``; OLMo-2's,
``mean_gap``, over every checked token. The sampled tokens' own
statistics (``sampled_*``) are reported beside it.

Besides the gaps: every finished request carries as many tokens as it
asked for, each inside the vocabulary, and no request failed before the
window closed.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.model import Arch, next_token_logits


def pick(requests: list[dict], seed: int, min_tokens: int,
         max_requests: int, greedy: bool) -> list[dict]:
    """The longest finished request decoded as ``greedy`` says, then
    others in an order drawn from ``seed`` until ``min_tokens`` served
    tokens or ``max_requests`` requests are in."""
    ok = [r for r in requests if r["greedy"] == greedy and not r["cut"]
          and r["error"] is None and len(r["tokens"]) == r["max_new"]]
    if not ok:
        return []
    ok.sort(key=lambda r: (r["client"], r["i"]))
    longest = max(ok, key=lambda r: (r["prompt_len"] + r["max_new"],
                                     -r["client"], -r["i"]))
    rest = [r for r in ok if r is not longest]
    order = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), 7, int(greedy)])
    ).permutation(len(rest))
    out, n = [longest], longest["max_new"]
    for j in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[int(j)])
        n += rest[int(j)]["max_new"]
    return out


def nucleus_floor(logits: torch.Tensor, temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    """Per row of ``logits [n, V]``: the least logit of the tokens the
    reference's nucleus allows (module docstring)."""
    scaled = logits / temperature
    k = top_k if 0 < top_k < logits.shape[-1] else logits.shape[-1]
    top = scaled.topk(k, dim=-1).values
    probs = torch.exp(top - torch.logsumexp(scaled, dim=-1, keepdim=True))
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep[:, 0] = True
    return torch.where(keep, top, torch.inf).min(dim=-1).values * temperature


def gaps(hf: dict, params: dict, sample: list[dict]) -> dict:
    """Per served token of the sample: ``gap`` (below the least logit the
    reference allows), ``sampled`` (whether its request sampled), and for
    a MoE model ``router`` (the reference's closest router tie over the
    layers, ``reference.model._moe``)."""
    if not sample:
        return {"gap": np.zeros(0), "sampled": np.zeros(0, bool)}
    arch = Arch.from_hf(hf)
    seqs = [r["prompt"] + r["tokens"][:-1] for r in sample]
    rows = [list(range(r["prompt_len"] - 1, len(s)))
            for r, s in zip(sample, seqs)]
    router: list = []
    logits = next_token_logits(arch, params, seqs, rows, router)
    gap, sampled = [], []
    for r, lg in zip(sample, logits):
        tok = torch.tensor(r["tokens"], device=lg.device)
        served = lg.gather(1, tok[:, None])[:, 0]
        if r["greedy"]:
            floor = lg.max(dim=-1).values
        else:
            kn = r["knobs"]
            floor = nucleus_floor(lg, float(kn["temperature"]),
                                  int(kn.get("top_k", 0)),
                                  float(kn.get("top_p", 1.0)))
        gap.append(torch.clamp(floor - served, min=0.0).cpu())
        sampled.append(torch.full((len(tok),), not r["greedy"]))
    out = {"gap": torch.cat(gap).numpy(),
           "sampled": torch.cat(sampled).numpy()}
    if router:
        out["router"] = torch.cat([m.cpu() for m in router]).numpy()
    return out


def gap_stats(per_token: dict, router_margin: float | None = None) -> dict:
    """The statistics a limits file may name, from :func:`gaps`'
    readings: over every checked token ``tokens``, ``max_gap``,
    ``mean_gap``; over the sampled ones the same with ``sampled_`` before
    each; ``clear_`` before either over the tokens whose router margin is
    at least ``router_margin`` (a MoE model only)."""
    g, smp = per_token["gap"], per_token["sampled"]
    groups = {"": np.ones_like(smp), "sampled_": smp}
    if router_margin is not None and "router" in per_token:
        clear = per_token["router"] >= router_margin
        groups |= {f"clear_{k}": m & clear for k, m in list(groups.items())}
    out = {}
    for pre, m in groups.items():
        sel = g[m]
        out[f"{pre}tokens"] = int(sel.size)
        if sel.size:
            out[f"{pre}max_gap"] = float(sel.max())
            out[f"{pre}mean_gap"] = float(sel.mean())
    return out


def output_faults(requests: list[dict], vocab: int) -> int:
    """Finished requests whose tokens are too few, too many or outside
    the vocabulary."""
    bad = 0
    for r in requests:
        if r["cut"] or r["error"] is not None:
            continue
        toks = r["tokens"]
        if len(toks) != r["max_new"] or any(t < 0 or t >= vocab for t in toks):
            bad += 1
    return bad


def judge(limits: dict, stats: dict, n_failed: int, n_bad: int,
          min_tokens: int) -> tuple[bool, dict]:
    """``(correct, checks)``: each compared number beside its limit; each
    gap statistic of ``limits["gaps"]`` also needs ``min_tokens`` tokens
    behind it."""
    checks = {
        "failed_requests": {"value": n_failed, "limit": 0},
        "bad_outputs": {"value": n_bad, "limit": 0},
    }
    for stat, limit in limits["gaps"].items():
        count = stat.replace("mean_gap", "tokens")
        checks[f"{count}.checked"] = {"value": stats.get(count, 0),
                                      "limit": min_tokens, "at_least": True}
        checks[stat] = {"value": stats.get(stat), "limit": limit}
    ok = True
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        if v is None or lim is None:
            ok = False
        elif c.get("at_least"):
            ok &= v >= lim
        else:
            ok &= v <= lim
    return bool(ok), checks

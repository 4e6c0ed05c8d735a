"""Tiny cells for the CPU tests: the toy configurations and mixes in
``tests/data`` with limits of their own, read as a run reads a cell."""

import json
from pathlib import Path

from benchmark.harness import Cell

DATA = Path(__file__).resolve().parent / "data"

# the toy widths' own limits: tiny runs of the program read a mean gap
# of 0.0003 logits or less; each planted fault reads 0.1 or more
LIMITS = {
    "olmo2": {"gaps": {"mean_gap": 0.03}},
    "mixtral": {"gaps": {"clear_mean_gap": 0.03}, "router_margin": 0.04},
}
SAMPLE = {"target_tokens": 120, "max_requests": 12, "min_tokens": 20}
E2E = ("output_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s")


def tiny_cell(model: str, mix: str) -> Cell:
    return Cell(
        name=f"tiny-{model}.{mix}", chips=1,
        config=json.loads((DATA / f"tiny-{model}.json").read_text()),
        traffic=json.loads((DATA / f"tiny-{mix}.json").read_text()),
        limits=LIMITS[model] | {"sample": SAMPLE},
        end_to_end=[{"name": n, "unit": "x"} for n in E2E],
        per_layer=[])

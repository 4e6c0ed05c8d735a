"""Model FLOPs of the work the window's chunks did for users, over the
window's seconds times the bf16 peak, in percent (``flops.chunk_flops``:
prompt rows and decoded tokens at their context; padded rows and experts
a token is not routed to count nothing)."""

from benchmark import flops, stats


def read(rec):
    packs = rec.get("window_packs")
    if not packs:
        return None
    work = sum(flops.chunk_flops(rec["widths"], p) for p in packs)
    return 100.0 * work / (stats.window_s(rec) * flops.PEAK_BF16_FLOPS)

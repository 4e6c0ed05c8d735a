"""``tl_paged_attention``'s device time against its bound, in percent:
over the chunks the trace holds whole, the least time the launches need
(``flops.chunk_paged_bound_s``) over the device seconds of the kernels
those launches ran."""

from benchmark import flops


def read(rec):
    dt = rec.get("devtrace")
    if not dt:
        return None
    bound = spent = 0.0
    for k, ch in dt["chunks"].items():
        pack = rec["packs"].get(k)
        if pack is None or ch["tl_paged_attention.n"] == 0:
            continue
        bound += flops.chunk_paged_bound_s(rec["widths"], pack)
        spent += ch["tl_paged_attention"]
    return 100.0 * bound / spent if spent > 0 else None

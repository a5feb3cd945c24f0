"""The whole step's share of the fp32 peak (67 TFLOP/s), in percent:
the operations the model needs per delivered row (each fired delta,
counted in the window's first third, at what the model family says it
costs in the sparse product it feeds; plus the rest of the row from
shapes, the family's ``row_ops``) times the rows the clients held per
second in its middle third."""


def read(rec):
    counts = rec.get("counts") or {}
    fired = counts.get("fired")
    if not fired or not fired["rows"]:
        return None
    cfg, fam = rec["cfg"], rec["family"]
    per_fired = fam.ops_per_fired(cfg)
    sparse = sum(per_fired[w] * n for w, n in fired["by_width"].items())
    per_row = sparse / fired["rows"] + fam.row_ops(cfg)
    ta, tb = rec["ta"], rec["tb"]
    rows = sum(n for t, n in rec.get("deliveries", ()) if ta <= t < tb)
    if not rows:
        return None
    flops = per_row * rows / (tb - ta)
    return 100.0 * flops / rec["peaks"]["fp32_flops_per_s"]

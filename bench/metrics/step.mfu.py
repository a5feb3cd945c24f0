"""The whole step's share of the fp32 peak (67 TFLOP/s), in percent:
the operations the model needs per delivered row (2 x each fired delta
x its column's kept weights, counted in the window's first third, plus
the encoder, pointwise and head operations from shapes) times the rows
the clients held per second in its middle third."""
from bench import counting


def read(rec):
    counts = rec.get("counts") or {}
    fired = counts.get("fired")
    if not fired or not fired["rows"]:
        return None
    cfg = rec["cfg"]
    per_fired = counting.lstm_ops_per_fired(cfg["hidden_dim"],
                                            cfg["gamma"], cfg["m"])
    per_row = (per_fired * fired["fired"] / fired["rows"]
               + counting.row_ops(cfg))
    ta, tb = rec["ta"], rec["tb"]
    rows = sum(n for t, n in rec.get("deliveries", ()) if ta <= t < tb)
    if not rows:
        return None
    flops = per_row * rows / (tb - ta)
    return 100.0 * flops / rec["peaks"]["fp32_flops_per_s"]

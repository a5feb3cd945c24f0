"""Share of the window with no device op running, in percent, as the
untraced system runs: the device's busy seconds per row delivered in the
profiled last third (the profiler slows the host, not the device's work
per row) times the rows delivered per second in the clean middle third."""


def read(rec):
    prof = rec.get("profile")
    deliveries = rec.get("deliveries")
    if not prof or not prof["busy_s"] or not deliveries:
        return None
    ta, tb = rec["ta"], rec["tb"]
    clean = sum(n for t, n in deliveries if ta <= t < tb)
    traced = sum(n for t, n in deliveries
                 if prof["t_on"] <= t < prof["t_off"])
    if not clean or not traced:
        return None
    busy_per_row = prof["busy_s"] / traced
    return 100.0 * (1.0 - busy_per_row * clean / (tb - ta))

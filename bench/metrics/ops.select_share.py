"""Device time of the route's selection kernels (the capacity clip's
top-k on the dense route, CTRL's sort on the scatter route, and their
scans) over the device's busy time, in percent."""
from bench.readers import kernel_totals

PATTERNS = ("topk", "sort", "radix", "bitonic", "scan")


def read(rec):
    got, prof = kernel_totals(rec, PATTERNS), rec.get("profile")
    if not got or not got[1] or not prof or not prof["busy_s"]:
        return None
    return 100.0 * got[1] / prof["busy_s"]

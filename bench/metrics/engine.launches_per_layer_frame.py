"""Device ops (kernels, copies, sets) per layer-step of the pool engine,
in the profiled last third: every op over the HPE kernel's launches."""
from bench.readers import layer_frames


def read(rec):
    prof, lf = rec.get("profile"), layer_frames(rec)
    return prof["launches"] / lf if prof and lf else None

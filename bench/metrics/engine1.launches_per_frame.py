"""Device ops (kernels, copies, sets) per frame of the batch-1 engine,
in the profiled last third (a frame is n_layers HPE launches)."""
from bench.readers import layer_frames


def read(rec):
    prof, lf = rec.get("profile"), layer_frames(rec)
    if not prof or not lf:
        return None
    return prof["launches"] * rec["cfg"]["n_layers"] / lf

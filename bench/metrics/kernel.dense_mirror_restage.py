"""How many times the dense-mirror kernel stages a fired mirror row a
call: the rows it staged (each pass of its rows stages their own union)
over the union of rows fired in the call, which its roofline charges
once; the program's launch counters summed over the window's boundary
samples."""
from bench.samples import boundary_samples


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    staged = union = 0
    for s in boundary_samples(rec):
        if "dense_mirror_union_inc" in s and t0 <= s.get("t_mono", -1) < t1:
            staged += s["dense_mirror_staged_inc"]
            union += s["dense_mirror_union_inc"]
    return staged / union if union else None

"""A/B device time of the port's CUDA kernel sources on one NVIDIA GPU.

    python tools/kernel_ab.py [--kernel spmv|delta_encode|lstm_pointwise|
                               dense_mirror] [--ptxas]
                              SOURCE[:NVCC_FLAG...] [SOURCE[:FLAG...] ...]

Each SOURCE is a version of ``src/repro_torch/kernels/csrc/
spartus_kernels.cu`` (the committed one, a copy of an earlier commit's,
or an edited variant); ``:``-separated flags after it are passed to nvcc
(``-DNAME`` switches in a variant).  Every source is built into
``build/kernel_ab/`` with the port's nvcc flags (all at once, once per
content), then one kernel of each
is timed at the 2x1024 model's shapes in the order A, B, ..., B, A, as
the mean device time of 50 launches from torch.profiler.  Prints one line
per source and case with the two times in ms.

* ``spmv``: ``spartus_stsp_spmv_{f32_i32,i8_i8}`` at layer shapes Q=2048
  and 1147, M=64, BLEN=4, K=Q/2, ~30% of the columns fired, B=16 and B=1.
  A source given without flags must equal the plain scatter on the host
  bit for bit.
* ``delta_encode``: the IPU stage at B=16 on layer 2 (D=1024) and layer 1
  (D=123), H=1024, fp32 and Q8.8, and at B=1; 12 of 16 slots active.
* ``lstm_pointwise``: the accumulate + HPE stage at B=16 and B=1,
  H=1024, 12 of 16 slots active.
* ``dense_mirror``: ``spartus_dense_mirror_{f32,i8}`` on a CBTD-pruned
  mirror (gamma 0.9375, M=64) at layer shapes Q=2048 and 1147, N=4096,
  with 30% and 5% of the deltas fired (``chip_smoke.py`` phase 2's share
  and the served model's), at B=1, 16 and 32.  A source given without
  flags must equal the float64 plain version on the card bit for bit,
  and every source must equal the first one bit for bit (the kernel's
  summation order is fixed, so two versions of it agree exactly).

For ``delta_encode`` and ``lstm_pointwise``, a source with the fused
entry point (``spartus_delta_encode_step`` /
``spartus_lstm_pointwise_step``) runs
the stage as the engines call it, state updated in place; a source with
only the unfused one (``spartus_delta_encode`` / ``spartus_lstm_pointwise``,
up to the commit that fused them) runs its kernel alone on the same
values, the concatenation and the add done beforehand.  A source given
without flags must equal the plain version on the card bit for bit.

``--ptxas`` prints, per source, what ``-Xptxas -v`` said of the bench's
kernel: registers, shared memory and spill bytes per instantiation.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_ab"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the unfused entry points of the sources before the fused ones
OLD_SIGNATURES = {
    "spartus_delta_encode": [_I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _F,
                             _F, _F, _P],
    "spartus_lstm_pointwise": [_I, _P, _P, _P, _P, _I, _I, _P],
}
# the entry points of sources from before the launch counters, which take
# no counters' pointers before the stream
_OLD_SPMV = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
UNCOUNTED_SIGNATURES = {
    "spartus_lstm_pointwise_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _P],
    **{f"spartus_stsp_spmv_{tags}": _OLD_SPMV
       for tags in ("f32_i32", "f32_i8", "i8_i32", "i8_i8")},
    "spartus_dense_mirror_f32": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    "spartus_dense_mirror_i8": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
}


def no_counters(lib, *nulls):
    """The null counter arguments a source's entry point takes: ``nulls``
    where it has the launch counters, nothing before them."""
    return nulls if lib.counted else ()


def build(specs):
    """Build every source (one nvcc each, all at once, once per content)
    and bind its entry points; returns the libraries in order."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for spec in specs:
        src, *flags = spec.split(":")
        digest = hashlib.sha256(" ".join(flags).encode()
                                + Path(src).read_bytes())
        lib = OUT / f"lib_{digest.hexdigest()[:16]}.so"
        proc = None if lib.exists() else subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((spec, lib, proc))
    handles = []
    for spec, lib, proc in jobs:
        if proc is not None:
            out, err = proc.communicate()
            if proc.returncode:
                sys.exit(f"nvcc failed on {spec}:\n{err[-3000:]}")
            lib.with_suffix(".log").write_text(out + err)
        handle = ctypes.CDLL(str(lib))
        handle.counted = b"long long* counts" in Path(
            spec.split(":")[0]).read_bytes()
        signatures = {**_build.SIGNATURES, **OLD_SIGNATURES}
        if not handle.counted:
            signatures.update(UNCOUNTED_SIGNATURES)
        for name, args in signatures.items():
            if hasattr(handle, name):
                getattr(handle, name).argtypes = args
                getattr(handle, name).restype = ctypes.c_int
        handles.append((handle, lib.with_suffix(".log")))
    return handles


def ptxas_lines(log: Path, kernel: str):
    """What ``-Xptxas -v`` said of every instantiation of ``kernel``: its
    properties and register lines, one string per instantiation."""
    out, current = [], None
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            current = line.split("'")[1] if kernel in line else None
            if current:
                out.append(current)
        elif current and ("spill" in line or "Used" in line):
            out[-1] += " | " + line.split(":", 1)[-1].strip()
    return out


def device_ms(torch, fn, kernel: str, iters: int = 50,
              tries: int = 3) -> float:
    """Mean device time of ``kernel`` over ``iters`` calls of ``fn``; a
    profile that caught fewer launches than calls is taken again, and
    after ``tries`` the reading is nan (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        if sum(e.count for e in events) >= iters:
            return sum(e.self_device_time_total
                       for e in events) / iters / 1e3
    print(f"kernel_ab: the profiler missed launches of {kernel}",
          file=sys.stderr)
    return float("nan")


# -- cases: (name, setup(lib) -> (call, check[, result])) --------------------


def spmv_cases(torch):
    from repro_torch.core import apply_cbtd, blen_for, cbcsc_encode
    from repro_torch.kernels import ops
    from repro_torch.kernels import stsp_spmv as sp

    gen = torch.Generator().manual_seed(0)
    out = []
    for q in (2048, 1147):
        w = apply_cbtd(torch.randn((4096, q), generator=gen) * 0.1, 0.9375,
                       64)
        enc = cbcsc_encode(w, 64, blen=blen_for(4096, 64, 0.9375))
        fired = torch.rand((16, q), generator=gen) < 0.3
        delta = torch.where(fired, torch.randn((16, q), generator=gen), 0.0)
        idx, ds, _ = ops.select_active_columns_batch(delta, q // 2)
        val8 = torch.round(enc.val / 2 ** -7).clamp(-127, 127).to(torch.int8)
        for label, v, l in (("f32", enc.val, enc.lidx),
                            ("i8", val8, enc.lidx.to(torch.int8))):
            for b in (16, 1):
                host = sp.plain_batch(v, l, idx[:b], ds[:b], enc.s)
                args = (v.cuda(), l.cuda(), idx[:b].contiguous().cuda(),
                        ds[:b].contiguous().cuda())
                out.append((f"Q={q} B={b} {label}",
                            spmv_setup(torch, label, args, enc.s, host)))
    return out


def spmv_setup(torch, label, args, s, host):
    def setup(lib):
        v, l, ii, dd = args
        lidx_tag = "i32" if label == "f32" else "i8"
        fn = getattr(lib, f"spartus_stsp_spmv_{label}_{lidx_tag}")
        b, k = ii.shape
        q, m, blen = v.shape
        y = torch.empty((b, s * m), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            return fn(0, v.data_ptr(), l.data_ptr(), ii.data_ptr(),
                      dd.data_ptr(), y.data_ptr(), b, k, q, m, blen, s,
                      *no_counters(lib, None, None), stream)

        return call, lambda: torch.equal(y.cpu(), host)
    return setup


def mixed_active(torch, b):
    return torch.arange(b, device="cuda") % 4 != 3


def delta_encode_cases(torch):
    from repro_torch.kernels import delta_encode as de

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b, d, act_bits in ((16, 1024, None), (16, 123, None),
                           (16, 1024, 16), (1, 1024, None)):
        x = torch.randn((b, d), generator=gen, device="cuda")
        h = torch.randn((b, 1024), generator=gen, device="cuda")
        s_hat = (torch.cat([x, h], -1) + 0.3 * torch.randn(
            (b, d + 1024), generator=gen, device="cuda"))
        out.append((f"B={b} D={d} H=1024 act_bits={act_bits}",
                    delta_encode_setup(torch, de, x, h, s_hat, act_bits)))
    return out


def delta_encode_setup(torch, de, x, h, s_hat0, act_bits):
    def setup(lib):
        b, d = x.shape
        f = s_hat0.shape[1]
        theta, quantize, scale, qmin, qmax = de._threshold_args(
            0.3, act_bits, 8)
        delta = torch.empty_like(s_hat0)
        nnz = torch.empty((b,), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if hasattr(lib, "spartus_delta_encode_step"):
            active = mixed_active(torch, b)
            state, want_state = s_hat0.clone(), s_hat0.clone()
            want_delta, want_nnz = de.plain_step(x, h, want_state, 0.3,
                                                 active, act_bits)

            def call():
                return lib.spartus_delta_encode_step(
                    0, x.data_ptr(), h.data_ptr(), state.data_ptr(),
                    active.data_ptr(), delta.data_ptr(), state.data_ptr(),
                    nnz.data_ptr(), b, d, f - d, theta, quantize, scale,
                    qmin, qmax, stream)
        else:
            s = torch.cat([x, h], -1)
            state = torch.empty_like(s_hat0)
            want_delta, want_state, want_nnz = de.plain(s, s_hat0, 0.3,
                                                        act_bits)

            def call():
                return lib.spartus_delta_encode(
                    0, s.data_ptr(), s_hat0.data_ptr(), delta.data_ptr(),
                    state.data_ptr(), nnz.data_ptr(), b, f, theta, quantize,
                    scale, qmin, qmax, stream)

        def check():
            return (torch.equal(delta, want_delta)
                    and torch.equal(nnz, want_nnz)
                    and torch.equal(state, want_state))
        return call, check
    return setup


def lstm_pointwise_cases(torch):
    from repro_torch.kernels import lstm_pointwise as lp

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b in (16, 1):
        # y small, so the delta memories stay in range over the launches
        dm = 2 * torch.randn((b, 4096), generator=gen, device="cuda")
        y = 0.01 * torch.randn((b, 4096), generator=gen, device="cuda")
        c = torch.randn((b, 1024), generator=gen, device="cuda")
        h = torch.randn((b, 1024), generator=gen, device="cuda")
        out.append((f"B={b} H=1024",
                    lstm_pointwise_setup(torch, lp, dm, y, c, h)))
    return out


def lstm_pointwise_setup(torch, lp, dm0, y, c0, h0):
    def setup(lib):
        b, hidden = c0.shape
        h_out = torch.empty_like(c0)
        stream = torch.cuda.current_stream().cuda_stream
        dm, c, h = dm0.clone(), c0.clone(), h0.clone()
        want_state = [dm0.clone(), c0.clone(), h0.clone()]
        if hasattr(lib, "spartus_lstm_pointwise_step"):
            active = mixed_active(torch, b)
            want = lp.plain_step(want_state[0], y, *want_state[1:], active)

            def call():
                return lib.spartus_lstm_pointwise_step(
                    0, dm.data_ptr(), y.data_ptr(), c.data_ptr(),
                    active.data_ptr(), h_out.data_ptr(), dm.data_ptr(),
                    c.data_ptr(), h.data_ptr(), b, hidden,
                    *no_counters(lib, None, 0, None), stream)
            state = [dm, c, h]
        else:
            dm_new = dm0 + y
            want, c_want = lp.plain(dm_new.view(b, 4, hidden), c0)
            want_state = [c_want]
            c_out = torch.empty_like(c0)

            def call():
                return lib.spartus_lstm_pointwise(
                    0, dm_new.data_ptr(), c.data_ptr(), h_out.data_ptr(),
                    c_out.data_ptr(), b, hidden, stream)
            state = [c_out]

        def check():
            return torch.equal(h_out, want) and all(
                torch.equal(a, w) for a, w in zip(state, want_state))
        return call, check
    return setup


def dense_mirror_cases(torch):
    from repro_torch.core import apply_cbtd
    from repro_torch.kernels import dense_mirror as dm

    gen = torch.Generator().manual_seed(0)
    out = []
    for q in (2048, 1147):
        wt = apply_cbtd(torch.randn((4096, q), generator=gen) * 0.1, 0.9375,
                        64).t().contiguous()
        scale = torch.tensor([2.0 ** -7])
        wt8 = torch.round(wt / scale).clamp(-127, 127).to(torch.int8)
        for p in (0.3, 0.05):
            fired = torch.rand((32, q), generator=gen) < p
            ds = torch.where(fired, torch.randn((32, q), generator=gen), 0.0)
            for label, w, sc in (("f32", wt, None), ("i8", wt8, scale)):
                d_w = w.cuda()
                d_sc = None if sc is None else sc.cuda()
                for b in (1, 16, 32):
                    d_ds = ds[:b].contiguous().cuda()
                    want = dm.plain(d_ds, d_w, d_sc)
                    out.append((f"Q={q} {int(p * 100)}% B={b} {label}",
                                dense_mirror_setup(torch, label, d_ds, d_w,
                                                   d_sc, want)))
    return out


def dense_mirror_setup(torch, label, ds, wt, scale, want):
    def setup(lib):
        fn = getattr(lib, f"spartus_dense_mirror_{label}")
        b, q = ds.shape
        n = wt.shape[1]
        y = torch.empty((b, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        sc = 0 if scale is None else scale.data_ptr()

        def call():
            return fn(0, ds.data_ptr(), wt.data_ptr(), sc, y.data_ptr(), b,
                      q, n, *no_counters(lib, None, None), stream)

        return call, lambda: torch.equal(y, want), lambda: y.clone()
    return setup


BENCHES = {
    "dense_mirror": (dense_mirror_cases, "dense_mirror_kernel"),
    "spmv": (spmv_cases, "stsp_spmv"),
    "delta_encode": (delta_encode_cases, "delta_encode"),
    "lstm_pointwise": (lstm_pointwise_cases, "lstm_pointwise"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(BENCHES), default="spmv")
    ap.add_argument("--ptxas", action="store_true",
                    help="print -Xptxas -v's lines for the bench's kernel")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    libs = list(zip(args.sources, build(args.sources)))
    make_cases, event = BENCHES[args.kernel]
    cases = make_cases(torch)
    runs = list(range(len(libs))) + list(reversed(range(len(libs))))
    times, firsts = {}, {}
    for i in runs:
        spec, (lib, _) = libs[i]
        for name, setup in cases:
            call, check, *result = setup(lib)
            if call() != 0:
                sys.exit(f"{spec} {name}: launch failed")
            torch.cuda.synchronize()
            if ":" not in spec and not check():
                sys.exit(f"{spec} {name}: differs from the plain version")
            if result:
                got = result[0]()
                if not torch.equal(got, firsts.setdefault(name, got)):
                    sys.exit(f"{spec} {name}: differs from "
                             f"{libs[0][0]} bit for bit")
            times.setdefault((spec, name), []).append(
                device_ms(torch, call, event))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for (spec, name), t in times.items():
        print(f"{spec:40s} {name:28s} " + " ".join(f"{x:.5f}" for x in t))
    if args.ptxas:
        for spec, (_, log) in libs:
            for line in ptxas_lines(log, event):
                print(f"ptxas {spec}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

// Hand-written Hopper (sm_90a) kernels of the Spartus datapath: the CUDA
// ports of the four Pallas TPU kernels of src/repro/kernels/, the
// batch-invariant dense-mirror product that stands in for an XLA dot, and
// the dense route's count and capacity clip in one launch.
//
// Plain C interface, bound from Python with ctypes
// (src/repro_torch/kernels/_build.py).  Every entry point takes the CUDA
// device index first and the stream last, makes that device current for
// the call and gives the caller's current device back on return (a pool
// sharded over several cards launches on each in turn, and PyTorch reads
// the current device for every tensor it places on "cuda"), launches on
// that stream (the caller passes PyTorch's current stream), allocates
// nothing, does not synchronise, and returns cudaGetLastError().
//
// Arithmetic that feeds the recurrence is written with explicit
// round-to-nearest intrinsics (__fmul_rn / __fadd_rn) so nvcc cannot fuse
// it into FMAs: each kernel then rounds where its plain PyTorch version
// (src/repro_torch/kernels/ref.py) rounds.
//
// State that a kernel updates in place (x_hat, dm, c) is read and written
// through pointers that may alias, so those pointers carry no
// __restrict__: each element is read and then written by one thread, and
// the compiler must keep that order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The entry point's device made current for the scope; the caller's
// current device is restored when the scope ends.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) {
      prev = -1;
    } else if (prev == device) {
      prev = -1;
    } else {
      err = cudaSetDevice(device);
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
};

// ---------------------------------------------------------------------------
// Launch counters of the pool's sparse products
//
// The product's and the HPE's entry points take two more pointers before
// the stream, null when nothing counts: `counts`, one layer's four int64
// counters [calls, fired, union, staged], and `marks`, one byte per
// column of its [B, Q] deltas.  The product's launch (dense mirror or
// scatter SpMV) adds its call, its fired entries and the mirror rows or
// CBCSC columns it staged, and sets the mark of every column some row
// fired; the layer's HPE launch, which follows it on the stream, counts
// the marks into `union` and clears them.  So a layer-step counts in the
// launches it already makes, on the device, and a CUDA graph that
// replays them counts too.  Counting is a template parameter of the three
// kernels: null pointers run the instantiations without it, which compile
// to the kernels as they were (with a runtime test instead the dense
// mirror read 4-5% slower at B = 1024, the SpMV 2-3%), and a counted
// launch runs the same loops with the counting added.  The
// counts read no value the arithmetic writes, and the arithmetic reads
// nothing they write: outputs are bit-identical either way.
// ---------------------------------------------------------------------------
constexpr int kCountCalls = 0;   // the HPE adds to [2], union, by its
constexpr int kCountFired = 1;   // own pointer
constexpr int kCountStaged = 3;

// The HPE's half: the marks [n] counted into *count and cleared; the grid
// strides over them a warp at a time (blockDim.x a multiple of 32), one
// atomic a warp that found any.
__device__ __forceinline__ void count_marks(unsigned char* __restrict__ marks,
                                            int n,
                                            unsigned long long* count) {
  const int lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i0 = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x - lane;
       i0 < static_cast<size_t>(n); i0 += stride) {
    const size_t i = i0 + lane;
    const bool set = i < static_cast<size_t>(n) && marks[i] != 0;
    if (set) marks[i] = 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    if (lane == 0 && ballot != 0) {
      atomicAdd(count, static_cast<unsigned long long>(__popc(ballot)));
    }
  }
}

// ---------------------------------------------------------------------------
// delta_encode: the IPU stage of one layer-step
//
// Replaces: src/repro/kernels/delta_encode.py:delta_encode_pallas
//           (body _delta_encode_kernel), vmapped over slots by
//           ops.delta_encode_batch, and the step glue around it in
//           serving/batched_engine.py (the concatenation of the layer
//           input with the previous hidden state, and the masked
//           write-back of the reference state).
// Computes: eqs. (4)-(5) of the paper for every slot b of the layer state
//           s = [x | h] ([B, D] and [B, H], read through two pointers):
//           delta = where(|s - s_hat| > theta, s - s_hat, 0),
//           nnz[b] = number fired, for every row; and
//           s_hat_out = where(fired, s, s_hat) for the rows whose
//           active[b] is set (all rows when active is null).  A row left
//           out is not written at all, so in place (s_hat_out == s_hat)
//           its state comes back bit for bit, -0.0 and NaN payloads
//           included.  With `quantize`, s is first snapped to the Qm.n
//           grid (clip(rint(s / scale), qmin, qmax) * scale); theta
//           arrives snapped by the wrapper.
// Bound:    bytes.  Four fp32 streams of B*F (two read, two written) and
//           one flop-free compare per element; at the serving shapes
//           (B=16, F<=2048) the 0.5 MB it moves takes ~0.15 us at
//           3.35 TB/s, so a launch is latency bound: what counts is how
//           many of a call's loads are in flight at once.
// Design:   one 1024-thread block per slot row, each thread holding E
//           (compile-time) elements of the row, all 2E loads issued
//           before the first compare or store: the 16 x 2048 elements of
//           a pool call are in flight in one round trip rather than eight.
//           The fired count is an exact integer sum: registers, warp
//           shuffles, one shared-memory pass; no atomics, no zeroing
//           launch.  Loads are 4-byte and coalesced, since layer 1's
//           D=123 and F=1147 leave rows unaligned for wider ones.
//           Measured on an H100 (tools/kernel_ab.py), B=16, F=2048:
//           0.0023 ms against 0.0010 for an empty launch; 512 threads
//           with E=4 read the same, and a cluster of up to 8 blocks per
//           row, counts summed through distributed shared memory,
//           0.0032: its two cluster barriers cost more than the wider
//           spread gained.
// ---------------------------------------------------------------------------
constexpr int kEncodeMaxThreads = 1024;

// count summed over the block; valid in thread 0
__device__ __forceinline__ int block_sum(int count) {
  __shared__ int warp_counts[32];
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    count = lane < n_warps ? warp_counts[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
    }
  }
  return count;
}

// E elements per thread; one block per row
template <int E>
__global__ void __launch_bounds__(kEncodeMaxThreads)
    delta_encode_kernel(const float* __restrict__ x,
                        const float* __restrict__ h, const float* s_hat,
                        const unsigned char* __restrict__ active,
                        float* __restrict__ delta, float* s_hat_out,
                        int* __restrict__ nnz, int D, int H, float theta,
                        int quantize, float scale, float qmin, float qmax) {
  const int F = D + H;
  const int b = blockIdx.x;
  const float* x_b = x + static_cast<size_t>(b) * D;
  const float* h_b = h + static_cast<size_t>(b) * H;  // unread when H = 0
  const size_t row = static_cast<size_t>(b) * F;
  const bool write = active == nullptr || active[b] != 0;
  const int span = E * blockDim.x;
  int count = 0;
  for (int base = 0; base < F; base += span) {
    float s[E], ref[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = base + e * blockDim.x + threadIdx.x;
      s[e] = i < D ? x_b[i] : i < F ? h_b[i - D] : 0.0f;
      ref[e] = i < F ? s_hat[row + i] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = base + e * blockDim.x + threadIdx.x;
      if (i >= F) continue;
      float v = s[e];
      if (quantize) {
        // scale is a power of two: the division and product are exact
        v = __fmul_rn(fminf(fmaxf(rintf(v / scale), qmin), qmax), scale);
      }
      const float raw = __fsub_rn(v, ref[e]);
      const bool fired = fabsf(raw) > theta;
      delta[row + i] = fired ? raw : 0.0f;
      if (write) s_hat_out[row + i] = fired ? v : ref[e];
      count += fired ? 1 : 0;
    }
  }
  count = block_sum(count);
  if (threadIdx.x == 0) nnz[b] = count;
}

// ---------------------------------------------------------------------------
// lstm_pointwise: the accumulate + HPE stage of one layer-step
//
// Replaces: src/repro/kernels/lstm_pointwise.py:lstm_pointwise_pallas
//           (body _lstm_pointwise_kernel), vmapped over slots by
//           ops.lstm_pointwise_batch, and the step glue around it in
//           serving/batched_engine.py (the delta-memory accumulate
//           dm + y and the masked write-back of dm, c and h).
// Computes: for every slot b and unit j, with y null meaning 0:
//           dm' = dm + y (one float32 add per gate, gate order i, g, f,
//           o over dm [B, 4, H]), c' = sigmoid(f) * c + sigmoid(i) *
//           tanh(g), h = sigmoid(o) * tanh(c').  h goes to h_out for
//           every row; dm' (if dm_out is given), c' and h (if h_state is
//           given) are written for the rows whose active[b] is set (all
//           when active is null), so in place a row left out comes back
//           bit for bit.
// Bound:    bytes.  In place, reads 9 and writes 7 fp32 values per (slot,
//           unit): 1.05 MB at B=16, H=1024, ~0.31 us at 3.35 TB/s (0.46 MB
//           without y and state); the few dozen flops and five float64
//           transcendentals per element are ~0.1 us of the card's fp64
//           rate, so a launch is latency bound: load round trip, then
//           the float64 chains.
// Design:   one thread per (slot, unit), in the widest blocks (<= 256
//           threads) that still give every SM a block.  A thread issues
//           all its loads before any arithmetic, and its four gate
//           transcendentals are independent, so their float64 sequences
//           interleave.  Measured on an H100 (tools/kernel_ab.py), B=16,
//           H=1024: 0.0025 ms against 0.0010 for an empty launch, the
//           same with 64 blocks of 256 threads, 0.0017 with float32
//           transcendentals: the float64 chains' latency, not the fp64
//           pipe or the SM count, sets the rest.  sigmoid and tanh run in
//           double and round to float: the correctly rounded value
//           (barring a near-tie), bit-identical to the plain version on
//           the host and on the card, where float library versions
//           differ by an ulp that the delta thresholds downstream would
//           amplify.
// ---------------------------------------------------------------------------
constexpr int kPointwiseMaxThreads = 256;

__device__ __forceinline__ float sigmoid_rn(float v) {
  return static_cast<float>(1.0 / (1.0 + exp(-static_cast<double>(v))));
}

__device__ __forceinline__ float tanh_rn(float v) {
  return static_cast<float>(tanh(static_cast<double>(v)));
}

// COUNT: count and clear the layer's marks (the launch counters).
template <bool COUNT>
__global__ void __launch_bounds__(kPointwiseMaxThreads)
    lstm_pointwise_kernel(const float* dm, const float* __restrict__ y,
                          const float* c,
                          const unsigned char* __restrict__ active,
                          float* __restrict__ h_out, float* dm_out,
                          float* c_out, float* __restrict__ h_state, int B,
                          int H, unsigned char* __restrict__ marks,
                          int n_marks, unsigned long long* union_count) {
  if constexpr (COUNT) count_marks(marks, n_marks, union_count);
  const size_t n = static_cast<size_t>(B) * H;
  const size_t hs = static_cast<size_t>(H);
  for (size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = t / hs;
    const size_t g = t + 3 * b * hs;  // gate i of (b, j) in [B, 4, H]
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = dm[g + k * hs];
    const float cv = c[t];
    const bool write = active == nullptr || active[b] != 0;
    if (y != nullptr) {
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = y[g + k * hs];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], a[k]);
    }
    const float gi = sigmoid_rn(d[0]);
    const float gg = tanh_rn(d[1]);
    const float gf = sigmoid_rn(d[2]);
    const float go = sigmoid_rn(d[3]);
    const float cn = __fadd_rn(__fmul_rn(gf, cv), __fmul_rn(gi, gg));
    const float hv = __fmul_rn(go, tanh_rn(cn));
    h_out[t] = hv;
    if (write) {
      if (dm_out != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dm_out[g + k * hs] = d[k];
      }
      c_out[t] = cn;
      if (h_state != nullptr) h_state[t] = hv;
    }
  }
}

// ---------------------------------------------------------------------------
// stsp_spmv (scatter)
//
// Replaces: src/repro/kernels/stsp_spmv.py:stsp_spmv_scatter_batch_pallas
//           (body _stsp_scatter_batch_kernel) for the pool, and
//           stsp_spmv.py:stsp_spmv_pallas (body _stsp_kernel, the one-hot
//           form) for the batch-1 engine, launched with B = 1.
// Computes: y[b, lidx * M + pe] += ds[b, k] * val[idx[b, k], pe, j] for
//           every slot b, list entry k, PE pe and burst slot j: the
//           spatio-temporal sparse MxV over CBCSC weights.  Duplicate
//           columns accumulate; entries with ds = 0 (the list's padding)
//           or idx outside [0, Q), and pairs with lidx outside [0, S), add
//           nothing.  val is fp32 or int8 (its scale is applied by the
//           caller on the [B, S*M] output), lidx int32 or int8, widened
//           before any row arithmetic.  Order contract: every output row
//           sums over the list in order, k ascending and then j, each step
//           acc = __fadd_rn(acc, __fmul_rn(ds, (float)val)) from 0, as the
//           plain scatter on the host adds it.  The result therefore does
//           not depend on B, the grid or the tile: bit-identical to the
//           host scatter, and the pool to the batch-1 engine.
// Bound:    bytes, and data dependent: per active entry one [M, BLEN]
//           slab of val and of lidx (2 KB fp32 / 512 B int8 at M=64,
//           BLEN=4), plus the [B, K] list and the [B, S*M] output; two
//           flops per fetched pair.  With the memory latency hidden by the
//           staging below, what holds the kernel is the per-PE scan: every
//           lane of a PE reads each live entry's BLEN pairs as shared-
//           memory broadcasts and tests each pair against its ceil(S/16)
//           rows.  Measured on an H100 (tools/spmv_ab.py), B=16: with a
//           warp per PE the loads and loop alone took 55% of the time and
//           the compares and adds the rest; the bytes would take 1/25 of
//           the time the kernel takes now.
// Design:   grid (slot, group of P PEs), P a power of two dividing M that
//           the launcher picks so the grid is about one wave of SMs (B=16,
//           M=64: P=8, 128 blocks of 4 warps; B=1: P=2, 32 blocks).  A
//           PE's rows l*M + pe belong to no other PE, so blocks never
//           share an output: no atomics, no second pass.  A half-warp per
//           PE, lane t of it owning rows l = t, t+16, ... in R registers:
//           one 16-byte broadcast load then feeds two PEs, halving the
//           shared-memory traffic per PE, which at B=16 outweighs the
//           doubled compares per lane (with B=1's 64 PEs on 32 warps it
//           does not: tools/spmv_ab.py).  Each warp stages its own two
//           PEs' data, so no block barrier waits per tile: its lanes
//           prefetch the slot's list a tile (T entries) ahead into
//           registers, compact the tile's live entries in list order with
//           a ballot (padding costs no copy), and cp.async each live
//           entry's slab slice for the two PEs (2*BLEN values and lidx, 32
//           bytes each at fp32/int32) into a double-buffered ring in shared
//           memory, so tile i+1 is in flight while tile i is summed.  The
//           sum runs a group of entries at a time, the next group's loads
//           in flight, and adds each pair to the row register it matches
//           with a predicated add: no shared read-modify-write, only the
//           register sum carries a dependence.  y is written once, through
//           shared memory, P neighbouring PEs of a row per store.  Work
//           scales with K*BLEN per PE whatever the hits; bucketing the list
//           by row per PE (stably) is the next step.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int unit) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (unit) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    default:  // a slice that is not 4-byte aligned: a plain byte copy
      *static_cast<unsigned char*>(dst) =
          *static_cast<const unsigned char*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent commit group of this thread have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One PE's BLEN=4 values or lidx as one shared-memory word: 16 bytes at
// fp32/int32, four packed bytes at int8.  at(w, j) widens element j.
template <typename T>
struct Slice4;
template <>
struct Slice4<float> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& w, int j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};
template <>
struct Slice4<int32_t> {
  using type = int4;
  static __device__ __forceinline__ int at(const int4& w, int j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};
template <>
struct Slice4<int8_t> {
  using type = int;
  static __device__ __forceinline__ int at(int w, int j) {
    return (w << (24 - 8 * j)) >> 24;  // sign-extends byte j
  }
};

// the lidx of a slot past the end of the list: -1 matches no row
__device__ __forceinline__ int4 no_rows(int4) {
  return make_int4(-1, -1, -1, -1);
}
__device__ __forceinline__ int no_rows(int) { return -1; }

// acc += p, rounded to nearest, if l == row: one predicated add, so the
// row register's dependence chain holds adds only
__device__ __forceinline__ void add_if_row(float& acc, int l, int row,
                                           float p) {
  asm("{\n\t.reg .pred hit;\n\t"
      "setp.eq.s32 hit, %1, %2;\n\t"
      "@hit add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(acc)
      : "r"(l), "r"(row), "f"(p));
}

template <int R>
__device__ __forceinline__ void add_pair(float (&acc)[R],
                                         const int (&rows)[R], float d,
                                         float v, int l) {
  const float p = __fmul_rn(d, v);
#pragma unroll
  for (int i = 0; i < R; ++i) add_if_row(acc[i], l, rows[i], p);
}

template <typename V, typename L, int R>
__device__ __forceinline__ void add_entry4(
    float (&acc)[R], const int (&rows)[R], float d,
    const typename Slice4<V>::type& v, const typename Slice4<L>::type& l) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    add_pair<R>(acc, rows, d, static_cast<float>(Slice4<V>::at(v, j)),
                Slice4<L>::at(l, j));
  }
}

constexpr int kSpmvMaxTile = 128;          // NZI list entries per tile
constexpr int kSpmvGroup = 4;              // entries summed per step
constexpr int kSpmvListRegs = kSpmvMaxTile / 32;  // per lane and tile
constexpr int kSpmvLanes = 16;             // lanes per PE: a half-warp
constexpr int kSpmvMaxWarps = 8;           // per block
constexpr int kSpmvMaxRowRegs = 32;        // row registers per lane
constexpr int kSpmvSmemBudget = 96 * 1024;  // staging bytes per block
constexpr int kMaxDevices = 64;

// Shared bytes one warp stages per tile: for each of two buffers and T
// entries, the live entry's ds and its two PEs' BLEN values and lidx.
__host__ __device__ constexpr int spmv_warp_bytes(int tile, int slice_v,
                                                  int slice_l) {
  return align16(2 * tile * 4) + align16(2 * tile * 2 * slice_v) +
         align16(2 * tile * 2 * slice_l);
}

// The SpMV's launch counters for slot b, the list shared out over the
// slot's blocks (counted by the slot's first block alone, the counted
// SpMV read 6% slower at B = 1024 and BLEN 2, against 2% so): its live
// list entries, each the staging of one CBCSC column, count as fired and
// staged, and mark their columns; block (0, 0) counts the call.
__device__ __forceinline__ void count_list(const int* __restrict__ idx_b,
                                           const float* __restrict__ ds_b,
                                           int K, int Q, bool first,
                                           unsigned long long* counts,
                                           unsigned char* marks) {
  const int lane = threadIdx.x & 31;
  unsigned n = 0;
  for (int k = blockIdx.y * blockDim.x + threadIdx.x; k < K;
       k += gridDim.y * blockDim.x) {
    const int col = idx_b[k];
    if (ds_b[k] != 0.0f &&
        static_cast<unsigned>(col) < static_cast<unsigned>(Q)) {
      marks[col] = 1;
      ++n;
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (first && threadIdx.x == 0) atomicAdd(&counts[kCountCalls], 1ull);
  if (lane == 0 && n != 0) {
    atomicAdd(&counts[kCountFired], static_cast<unsigned long long>(n));
    atomicAdd(&counts[kCountStaged], static_cast<unsigned long long>(n));
  }
}

// R = row registers per lane (>= ceil(S/16)); BLEN_C = 4 reads a PE's
// pairs with one vector load per array, 0 loops over a runtime BLEN.
// grid (B, M / P), blockDim.x = 32 * ceil(P / 2): half-warp h of warp w
// serves PE pe0 + 2w + h.  Dynamic shared memory holds one region per
// warp: live ds [2][T] | val [2][T][2 PEs][BLEN] | lidx [2][T][2][BLEN];
// at the end it is reused for the block's [S][P] output.  COUNT: keep
// the launch counters.
template <typename V, typename L, int R, int BLEN_C, bool COUNT>
__global__ void __launch_bounds__(32 * kSpmvMaxWarps)
    stsp_spmv_kernel(const V* __restrict__ val, const L* __restrict__ lidx,
                     const int* __restrict__ idx,
                     const float* __restrict__ ds, float* __restrict__ y,
                     int K, int Q, int M, int BLEN, int S, int P, int T,
                     int unit_v, int unit_l,
                     unsigned long long* __restrict__ counts,
                     unsigned char* __restrict__ marks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blen = BLEN_C > 0 ? BLEN_C : BLEN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane / kSpmvLanes;
  const int b = blockIdx.x;
  const int pe0 = blockIdx.y * P;
  const int warp_pe = 2 * warp;                  // first PE of the warp
  const int warp_pes = min(2, P - warp_pe);      // 1 if P is odd
  const int slice_v = blen * static_cast<int>(sizeof(V));
  const int slice_l = blen * static_cast<int>(sizeof(L));
  unsigned char* region =
      smem + static_cast<size_t>(warp) * spmv_warp_bytes(T, slice_v, slice_l);
  float* live_ds = reinterpret_cast<float*>(region);
  unsigned char* ring_v = region + align16(2 * T * 4);
  unsigned char* ring_l = ring_v + align16(2 * T * 2 * slice_v);
  // the warp's PEs are neighbours: one contiguous slice of column col,
  // col * M * slice bytes in
  const auto* val_w = reinterpret_cast<const unsigned char*>(val) +
                      static_cast<size_t>(pe0 + warp_pe) * slice_v;
  const auto* lidx_w = reinterpret_cast<const unsigned char*>(lidx) +
                       static_cast<size_t>(pe0 + warp_pe) * slice_l;
  const size_t col_v = static_cast<size_t>(M) * slice_v;
  const size_t col_l = static_cast<size_t>(M) * slice_l;
  const int copy_v = warp_pes * slice_v, copy_l = warp_pes * slice_l;
  const int* idx_b = idx + static_cast<size_t>(b) * K;
  const float* ds_b = ds + static_cast<size_t>(b) * K;
  const int n_tiles = (K + T - 1) / T;
  const unsigned lanes_below = (1u << lane) - 1u;
  if (COUNT) {
    count_list(idx_b, ds_b, K, Q, b == 0 && blockIdx.y == 0, counts, marks);
  }

  int rows[R];
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    rows[i] = lane % kSpmvLanes + kSpmvLanes * i;
    acc[i] = 0.0f;
  }

  // lane's list entries j*32 + lane of a tile; past the end: padding
  struct List {
    int idx[kSpmvListRegs];
    float ds[kSpmvListRegs];
  };
  auto load_list = [&](int tile) {
    List list;
    const int k0 = tile * T;
    const int n = tile < n_tiles ? min(T, K - k0) : 0;
#pragma unroll
    for (int j = 0; j < kSpmvListRegs; ++j) {
      const int e = j * 32 + lane;
      list.idx[j] = e < n ? idx_b[k0 + e] : 0;
      list.ds[j] = e < n ? ds_b[k0 + e] : 0.0f;
    }
    return list;
  };
  // a tile's live entries, compacted in list order into ring buffer buf;
  // returns their count
  auto stage = [&](const List& list, int buf) {
    int n_live = 0;
#pragma unroll
    for (int j = 0; j < kSpmvListRegs; ++j) {
      const int col = list.idx[j];
      const bool live = list.ds[j] != 0.0f &&
                        static_cast<unsigned>(col) < static_cast<unsigned>(Q);
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int slot = buf * T + n_live + __popc(mask & lanes_below);
        live_ds[slot] = list.ds[j];
        for (int u = 0; u < copy_v; u += unit_v) {
          cp_async(ring_v + slot * 2 * slice_v + u, val_w + col * col_v + u,
                   unit_v);
        }
        for (int u = 0; u < copy_l; u += unit_l) {
          cp_async(ring_l + slot * 2 * slice_l + u, lidx_w + col * col_l + u,
                   unit_l);
        }
      }
      n_live += __popc(mask);
    }
    return n_live;
  };

  List ahead = load_list(1);
  int n_cur = stage(load_list(0), 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    // tile+1 goes into the buffer that tile-1 used, then the list a tile
    // further ahead is fetched while this tile is summed
    const int n_next = stage(ahead, (tile + 1) & 1);
    cp_async_commit();
    ahead = load_list(tile + 2);
    cp_async_wait_prior();  // this lane's copies of tile have landed
    __syncwarp();           // and every lane's, with live_ds
    const int buf = (tile & 1) * T;
    if constexpr (BLEN_C == 4) {
      // in list order, a group of kSpmvGroup entries at a time, the next
      // group's shared-memory loads in flight while this one is summed;
      // slots past the end match no row
      using V4 = typename Slice4<V>::type;
      using L4 = typename Slice4<L>::type;
      const V4* sv = reinterpret_cast<const V4*>(ring_v) + 2 * buf + half;
      const L4* sl = reinterpret_cast<const L4*>(ring_l) + 2 * buf + half;
      const float* sd = live_ds + buf;
      struct Group {
        V4 v[kSpmvGroup];
        L4 l[kSpmvGroup];
        float d[kSpmvGroup];
      };
      auto fetch = [&](int r0) {
        Group g;
#pragma unroll
        for (int e = 0; e < kSpmvGroup; ++e) {
          const int r = r0 + e;
          g.v[e] = r < n_cur ? sv[2 * r] : V4{};
          g.l[e] = r < n_cur ? sl[2 * r] : no_rows(L4{});
          g.d[e] = r < n_cur ? sd[r] : 0.0f;
        }
        return g;
      };
      Group cur = fetch(0);
      for (int r0 = 0; r0 < n_cur; r0 += kSpmvGroup) {
        const Group next = fetch(r0 + kSpmvGroup);
#pragma unroll
        for (int e = 0; e < kSpmvGroup; ++e) {
          add_entry4<V, L, R>(acc, rows, cur.d[e], cur.v[e], cur.l[e]);
        }
        cur = next;
      }
    } else {
      const int first = (2 * buf + half) * blen;
      const V* sv = reinterpret_cast<const V*>(ring_v) + first;
      const L* sl = reinterpret_cast<const L*>(ring_l) + first;
      for (int r = 0; r < n_cur; ++r) {
        const float d = live_ds[buf + r];
        for (int j = 0; j < blen; ++j) {
          add_pair<R>(acc, rows, d, static_cast<float>(sv[2 * r * blen + j]),
                      static_cast<int>(sl[2 * r * blen + j]));
        }
      }
    }
    __syncwarp();  // every lane is done with the buffer before its refill
    n_cur = n_next;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every warp is done: reuse the regions for the output
  float* s_out = reinterpret_cast<float*>(smem);
  if (half < warp_pes) {  // an odd P leaves the last half-warp idle
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rows[i] < S) s_out[rows[i] * P + warp_pe + half] = acc[i];
    }
  }
  __syncthreads();
  float* y_b = y + static_cast<size_t>(b) * S * M + pe0;
  for (int t = threadIdx.x; t < S * P; t += blockDim.x) {
    const int l = t / P;
    y_b[static_cast<size_t>(l) * M + (t - l * P)] = s_out[t];
  }
}

// The widest cp.async (16, 8 or 4 bytes; 1 = plain byte copies) that
// every PE's slice allows: the base address and the slice length (which
// every column and PE offset is a multiple of) must be multiples of it.
int copy_unit(const void* base, size_t slice_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int u = 16; u >= 4; u >>= 1) {
    if (a % u == 0 && slice_bytes % u == 0) return u;
  }
  return 1;
}

cudaError_t sm_count(int device, int* n) {
  static int counts[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && counts[device] > 0) {
    *n = counts[device];
    return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    counts[device] = *n;
  }
  return err;
}

template <typename V, typename L, int R, int BLEN_C>
cudaError_t run_stsp_spmv(int device, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const void* val,
                          const void* lidx, const int* idx, const float* ds,
                          float* y, int K, int Q, int M, int BLEN, int S,
                          int P, int T, int unit_v, int unit_l,
                          unsigned long long* counts, unsigned char* marks) {
  const bool count = counts != nullptr;
  const auto kernel = count ? stsp_spmv_kernel<V, L, R, BLEN_C, true>
                            : stsp_spmv_kernel<V, L, R, BLEN_C, false>;
  if (smem > 48 * 1024) {
    // opt in once per device and kernel, to the most any launch can ask for
    static bool opted[2][kMaxDevices] = {};
    if (device < 0 || device >= kMaxDevices || !opted[count][device]) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSpmvSmemBudget);
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) opted[count][device] = true;
    }
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const V*>(val), static_cast<const L*>(lidx), idx, ds, y, K,
      Q, M, BLEN, S, P, T, unit_v, unit_l, counts, marks);
  return cudaGetLastError();
}

template <typename V, typename L>
int launch_stsp_spmv(int device, const void* val, const void* lidx,
                     const int* idx, const float* ds, float* y, int B, int K,
                     int Q, int M, int BLEN, int S, long long* counts_i64,
                     unsigned char* marks, void* stream) {
  constexpr int kMaxRows = kSpmvLanes * kSpmvMaxRowRegs;
  auto* const counts = reinterpret_cast<unsigned long long*>(counts_i64);
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || M == 0 || S == 0) return 0;
  if (B < 0 || K < 0 || Q < 0 || M < 0 || BLEN < 0 || S > kMaxRows ||
      BLEN > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // P PEs per block, a power of two dividing M: two (a whole warp) where
  // M allows, and more while the grid would exceed one wave of SMs
  int pes = M % 2 == 0 ? 2 : 1;
  while (pes < 2 * kSpmvMaxWarps && M % (2 * pes) == 0 &&
         static_cast<long long>(B) * (M / pes) > n_sm) {
    pes *= 2;
  }
  const int slice_v = BLEN * static_cast<int>(sizeof(V));
  const int slice_l = BLEN * static_cast<int>(sizeof(L));
  // the longest tile (<= 128 entries) whose staging fits the budget;
  // fewer PEs per block when that is under 32 entries
  int tile = kSpmvMaxTile;
  while (tile > 1 && static_cast<size_t>((pes + 1) / 2) *
                             spmv_warp_bytes(tile, slice_v, slice_l) >
                         static_cast<size_t>(kSpmvSmemBudget)) {
    if (tile <= 32 && pes > 1) {
      pes /= 2;
    } else {
      tile = tile > 32 ? tile - 32 : tile - 1;
    }
  }
  const size_t staging = static_cast<size_t>((pes + 1) / 2) *
                         spmv_warp_bytes(tile, slice_v, slice_l);
  if (staging > static_cast<size_t>(kSpmvSmemBudget)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t out = static_cast<size_t>(S) * pes * sizeof(float);
  const size_t smem = staging > out ? staging : out;
  const int unit_v = copy_unit(val, slice_v);
  const int unit_l = copy_unit(lidx, slice_l);
  const dim3 grid(B, M / pes);
  const int threads = 32 * ((pes + 1) / 2);
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = (S + kSpmvLanes - 1) / kSpmvLanes;
#define SPMV_RUN(RR)                                                         \
  if (rows <= RR) {                                                          \
    err = BLEN == 4                                                          \
              ? run_stsp_spmv<V, L, RR, 4>(device, grid, threads, smem, st,   \
                                           val, lidx, idx, ds, y, K, Q, M,    \
                                           BLEN, S, pes, tile, unit_v,        \
                                           unit_l, counts, marks)             \
              : run_stsp_spmv<V, L, RR, 0>(device, grid, threads, smem, st,   \
                                           val, lidx, idx, ds, y, K, Q, M,    \
                                           BLEN, S, pes, tile, unit_v,        \
                                           unit_l, counts, marks);            \
    return static_cast<int>(err);                                            \
  }
  SPMV_RUN(1)
  SPMV_RUN(2)
  SPMV_RUN(4)
  SPMV_RUN(8)
  SPMV_RUN(16)
  SPMV_RUN(32)
#undef SPMV_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// dense_mirror: the dense-mirror SpMV's product, batch-invariant
//
// Replaces: no Pallas kernel.  It is the port's own repair of the XLA dot
//           in src/repro/kernels/ops.py:delta_spmv_dense_topk_batch
//           (ds [B, Q] @ wt [Q, N], an int8 mirror widened inside the GEMM
//           fusion).  cuBLAS picks another fp32 reduction order for 1 row
//           than for 16, and the recurrence amplifies the last bit: with
//           an fp32 product the pool drifted 0.52 in logits from the
//           batch-1 engine.
// Computes: y[b, j] = float(sum_k double(ds[b, k]) * double(wt[k, j])),
//           then y * scale[0] in float when scale is given (the int8
//           mirror's dequantization), with wt [Q, N] float or int8 at
//           rest.  Every product is exact in double, and the double sum
//           carries ~29 bits more than the float it rounds to, so y is the
//           float nearest the exact sum barring a near-tie: the value a
//           double GEMM (the plain version) gives, whatever its order.
// Order:    the k-sum of every output element is a function of Q alone.
//           k runs in chunks of 256; warp w sums k in [chunk + 32w, chunk
//           + 32w + 32) of every chunk, ascending, into one double
//           accumulator per row, and the block adds the warps' partials in
//           warp order, rounds once (__double2float_rn) and scales
//           (__fmul_rn).  fma(+-0, w, acc) == acc for finite w, and acc is
//           never -0 (it starts at +0, and round-to-nearest gives +0 for
//           an exact cancellation), so a term whose delta is +-0 may be
//           skipped or taken: either leaves every row's sequence of
//           roundings as it was.  Neither B nor the other rows of a launch
//           enter a row's sum, so a row is bit-identical whatever pool it
//           shares, and to the design this one replaced.  (The mirror is
//           finite: it holds weights.)
// Bound:    bytes for the data, operations for the kernel.  The bytes:
//           the mirror rows that some row of the launch fired, each read
//           once; at layer 2 of the 2x1024 model (Q = 2048, N = 4096)
//           with 30% of the deltas fired B = 16 touches every row, 33.5 MB
//           fp32, ~0.010 ms at 3.35 TB/s (int8 8.4 MB, ~0.0026); at the
//           served model's ~5%, B = 1 touches ~100 rows (~0.0005 ms) and
//           B = 16 ~56% of them.  The kernel's limit is the compute beside
//           the bytes: every fp64 FMA takes its delta as a broadcast from
//           shared memory (half a load a row and k in the dense pass, a
//           load and a mirror load a term in the walk), and those loads
//           and the FMAs, not the mirror's bytes, set the time from ~10%
//           fired at B = 16 upwards.
// Design:   one block of 8 warps per 32 output columns (a lane per
//           column), so N = 4096 gives 128 blocks for 132 SMs, with up to
//           32 rows a pass (RB) in registers.  Each warp runs its own
//           pipeline over its slices through a ring of 2 to 4 slots in
//           shared memory (as many as fit in a block's 227 KB).  To
//           stage a slice it ballots each row's fired k (the lanes hold
//           the rows' deltas, loaded two slices ahead), keeps the masks,
//           writes the widened deltas ([k][row] doubles), and cp.asyncs in
//           16-byte pieces only the mirror row segments of the k some row
//           fired (128 bytes fp32, 32 int8), so the next slices' loads fly
//           under this one's FMAs.  A slice is then computed one of two
//           ways, chosen when it is staged from how many of its k fired in
//           any row: the walk takes the rows in pairs and visits each
//           row's own fired k in ascending order (bit-reversed masks,
//           FLO), one FMA per fired term and none for a zero, a row out
//           of terms reading a zero row; the dense pass runs all 32 k
//           with every row, two rows' deltas a 16-byte broadcast, the
//           zeros included (a k no row fired meets zero deltas and a
//           finite stale value, the ring being zeroed at the start).
//           Past 32 rows the pass repeats, each reading the mirror rows
//           its own rows fired: the widened deltas (264 bytes a row and
//           slice) fill shared memory at 32.
// Measured: tools/kernel_ab.py --kernel dense_mirror against the design
//           it replaced, in one call (NVIDIA H100 80GB HBM3, 700 W; device
//           ms, layer 2, fp32 / int8): 30% fired B = 1 0.0088 / 0.0070
//           (was 0.0148 / 0.0148), B = 16 0.0289 / 0.0273 (0.0299 /
//           0.0296), B = 32 0.0512 / 0.0496 (0.0586 / 0.0580); 5% fired
//           B = 1 0.0064 / 0.0051 (0.0148 / 0.0147), B = 16 0.0213 /
//           0.0195 (0.0232 / 0.0230), B = 32 0.0345 / 0.0324 (0.0446 /
//           0.0443).  -Xptxas -v: 84 to 254 registers, no spills (with
//           the launch bound's one block an SM; without it ptxas capped
//           RB = 2, 4 and 8 at 128 and spilled 48-112 bytes, and int8 at
//           B = 8 took 0.0254 against 0.0163).  On the way: the walk
//           alone, one row at a time with 4-byte cp.async per live row
//           (an ffs loop), 0.099 at B = 16 / 30% (chains of shared loads
//           and FMAs that 8 warps an SM do not hide); the copies alone cost 0.024 of it, 0.014 as
//           16-byte pieces on a fixed map; the walk four rows at a time
//           0.054 against 0.029 for the dense pass (0.021 and 0.028 at
//           5%), so each slice takes the cheaper; 16 warps an SM (two a
//           slice, each half the rows, a named barrier a step) 0.035, so
//           the compute is throughput-bound; the walk from per-row index
//           lists built at staging (no FLO a term) 0.047 at 30% and no
//           faster at 5%; widening floats by bit moves (no F2F) and
//           holding the slice's mirror values in registers changed
//           nothing.  The fp64 tensor cores would reorder each k-step's
//           sums.
// ---------------------------------------------------------------------------
constexpr int kMirrorWarps = 8;
constexpr int kMirrorThreads = 32 * kMirrorWarps;
constexpr int kMirrorSlice = 32;  // k a warp takes of each 256
constexpr int kMirrorMaxRows = 32;
// a slot's k rows: the slice's 32, and a zero row (k = 32) that stands
// for "no term" in the walk
constexpr int kMirrorSlotRows = kMirrorSlice + 1;
constexpr size_t kMirrorSmemBudget = 232448;  // all of an H100 block's
// the walk visits rows in pairs
constexpr int kMirrorWalkRows = 2;
// the walk takes a slice whose union of fired k over the pass's RB rows
// (a k past Q counted as fired) is at most mirror_walk_live(RB) of its
// 32, the dense pass the others: where the two measured even, ~10% of
// the deltas fired at B = 16 and ~23% at B = 1
__host__ __device__ constexpr int mirror_walk_live(int rb) {
  return rb <= 1 ? 7 : rb <= 2 ? 12 : rb <= 4 ? 18 : rb <= 8 ? 23
         : rb <= 16 ? 26 : 31;
}

// doubles per k of a slot's widened deltas: RB rows, padded by two where
// the rows are 4 or more, so that lanes writing consecutive k spread over
// eight bank pairs; even, so that each row pair stays 16-byte aligned
__host__ __device__ constexpr int mirror_stride(int rb) {
  return rb >= 4 ? rb + 2 : rb;
}

// shared bytes of one warp's ring of `depth` slots: the mirror segments
// [33 k][32 columns], the widened deltas [33 k][stride], and the row
// masks [RB] and the pass to take of each slot
__host__ __device__ constexpr size_t mirror_warp_bytes(size_t w_bytes,
                                                       int rb, int depth) {
  return (static_cast<size_t>(depth) *
              (kMirrorSlotRows * 32 * w_bytes +
               kMirrorSlotRows * mirror_stride(rb) * sizeof(double) +
               (rb + 1) * sizeof(unsigned)) +
          15) / 16 * 16;
}

// the deepest ring (4, 3 or 2 slots) whose 8 warps fit the budget
__host__ __device__ constexpr int mirror_depth(size_t w_bytes, int rb) {
  return kMirrorWarps * mirror_warp_bytes(w_bytes, rb, 4) <=
                 kMirrorSmemBudget
             ? 4
             : kMirrorWarps * mirror_warp_bytes(w_bytes, rb, 3) <=
                       kMirrorSmemBudget
                   ? 3
                   : 2;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a mirror value as a double, exactly: F2F for a float; an int8 through
// the 2^52 + 2^31 bias (one add on the fp64 pipe instead of a conversion)
__device__ __forceinline__ double mirror_widen(float v) {
  return static_cast<double>(v);
}
__device__ __forceinline__ double mirror_widen(int8_t v) {
  const unsigned biased = static_cast<unsigned>(static_cast<int>(v)) ^
                          0x80000000u;
  return __hiloint2double(0x43300000, static_cast<int>(biased)) -
         4503601774854144.0;
}

// RB rows per pass (a power of two <= 32); grid ceil(N / 32),
// kMirrorThreads threads, 8 * mirror_warp_bytes(sizeof(W), RB, depth)
// bytes of dynamic shared memory.  unit: the widest cp.async (16 or 4
// bytes) that every row segment of the mirror allows, 0 for byte copies.
// COUNT: keep the launch counters (counts, marks).  Pass p of rows is
// counted by block p mod gridDim.x, so at B = 1024 the 32 passes' counts
// spread over 32 blocks instead of delaying one, and from the ring's row
// masks, outside the stage, whose registers are dearest (counted there,
// the kernel spilled and read 7% slower).
template <typename W, int RB, bool COUNT>
__global__ void __launch_bounds__(kMirrorThreads, 1)  // one block an SM
    dense_mirror_kernel(const float* __restrict__ ds,
                        const W* __restrict__ wt,
                        const float* __restrict__ scale,
                        float* __restrict__ y, int B, int Q, int N,
                        int unit, unsigned long long* __restrict__ counts,
                        unsigned char* __restrict__ marks) {
  constexpr int kDepth = mirror_depth(sizeof(W), RB);
  constexpr int kStride = mirror_stride(RB);
  constexpr int kSeg = kMirrorSlotRows * 32;        // mirror values a slot
  constexpr int kDsd = kMirrorSlotRows * kStride;   // deltas a slot
  constexpr int kWalk = RB < kMirrorWalkRows ? RB : kMirrorWalkRows;
  constexpr size_t kWarpBytes = mirror_warp_bytes(sizeof(W), RB, kDepth);
  static_assert(kMirrorWarps * kWarpBytes <= kMirrorSmemBudget,
                "the ring fits a block's shared memory");
  static_assert(RB * 32 * sizeof(double) <= kWarpBytes,
                "the partials [warp][RB][32] lie over the ring");
  extern __shared__ __align__(16) unsigned char mirror_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * 32;
  const int cols = N - j0;  // >= 1 columns of this block
  unsigned char* const base = mirror_smem + warp * kWarpBytes;
  W* const mir = reinterpret_cast<W*>(base);
  double* const dsd =
      reinterpret_cast<double*>(base + kDepth * kSeg * sizeof(W));
  unsigned* const msk = reinterpret_cast<unsigned*>(dsd + kDepth * kDsd);
  // this warp's slices: slice s covers k in [32 (8 s + warp), +32)
  const int n_slices = (Q + kMirrorSlice - 1) / kMirrorSlice;
  const int n = n_slices > warp
                    ? (n_slices - warp + kMirrorWarps - 1) / kMirrorWarps
                    : 0;
  if (COUNT && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(&counts[kCountCalls], 1ull);
  }

  for (int b0 = 0; b0 < B; b0 += RB) {
    // every block stages the same mirror rows for its own 32 columns: one
    // block counts the pass
    const bool counting =
        COUNT && (b0 / RB) % static_cast<int>(gridDim.x) ==
                     static_cast<int>(blockIdx.x);
    // a zeroed ring (the partials of the last pass lie over it): the
    // zero rows at k = 32 and, in the mirror segments a slice did not
    // copy, finite values only
    for (size_t o = lane * 16; o + 16 <= kWarpBytes; o += 32 * 16) {
      *reinterpret_cast<int4*>(base + o) = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    // lane i's deltas at k = slice start + i, RB rows, zero past B or Q
    auto load = [&](float (&v)[RB], int s) {
      const int k = kMirrorSlice * (kMirrorWarps * s + warp) + lane;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        v[r] = (b0 + r < B && k < Q)
                   ? ds[static_cast<size_t>(b0 + r) * Q + k]
                   : 0.0f;
      }
    };
    // the masks (bit-reversed: bit 31 is the slice's first k) and
    // widened deltas of slice s into its ring slot, and cp.async of the
    // mirror segments of the k some row fired
    auto stage = [&](const float (&v)[RB], int s) {
      const int slot = s % kDepth;
      const int k0 = kMirrorSlice * (kMirrorWarps * s + warp);
      double* const d = dsd + slot * kDsd + lane * kStride;
      unsigned live = 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const unsigned m = __ballot_sync(0xffffffffu, v[r] != 0.0f);
        live |= m;
        if (lane == 0) msk[slot * (RB + 1) + r] = __brev(m);
      }
      if (lane == 0) {
        const int past = k0 + kMirrorSlice > Q ? k0 + kMirrorSlice - Q : 0;
        msk[slot * (RB + 1) + RB] =
            __popc(live) + past <= mirror_walk_live(RB);
      }
      if constexpr (RB == 1) {
        d[0] = live ? mirror_widen(v[0]) : 0.0;
      } else {
#pragma unroll
        for (int r = 0; r < RB; r += 2) {
          *reinterpret_cast<double2*>(d + r) =
              make_double2(mirror_widen(v[r]), mirror_widen(v[r + 1]));
        }
      }
      W* const dst = mir + slot * kSeg;
      if (unit == 16) {
        // 16-byte pieces on a fixed map: kLanes lanes a row segment, row
        // t * kRows + lane / kLanes in pass t, copied if the row is live
        constexpr int kLanes = 32 * static_cast<int>(sizeof(W)) / 16;
        constexpr int kRows = 32 / kLanes;
        constexpr int kPer = 16 / static_cast<int>(sizeof(W));
        const int col = (lane % kLanes) * kPer;
#pragma unroll
        for (int t = 0; t < kMirrorSlice / kRows; ++t) {
          const int i = t * kRows + lane / kLanes;
          if (((live >> i) & 1u) && col < cols) {
            cp_async(dst + i * 32 + col,
                     wt + static_cast<size_t>(k0 + i) * N + j0 + col, 16);
          }
        }
        return;
      }
      while (live) {
        const int i = __ffs(live) - 1;
        live &= live - 1;
        const W* const src = wt + static_cast<size_t>(k0 + i) * N + j0;
        if (unit == 4) {
          constexpr int kPer = 4 / static_cast<int>(sizeof(W));
          if (lane * kPer < 32 && lane * kPer < cols) {
            cp_async(dst + i * 32 + lane * kPer, src + lane * kPer, 4);
          }
        } else if (lane < cols) {  // a plain byte copy, seen after the
          dst[i * 32 + lane] = src[lane];  // __syncwarp before the walk
        }
      }
    };

    double acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0;
    // the FMAs of slice s, in each row's order; either pass gives the same
    // bits (the dense one's extra terms are +-0 times finite values)
    auto compute = [&](int s) {
      const int slot = s % kDepth;
      const W* const w = mir + slot * kSeg + lane;
      const double* const d = dsd + slot * kDsd;
      if (msk[slot * (RB + 1) + RB]) {
        // each row's own fired k, ascending, kWalk rows at a time; a row
        // out of terms reads the zero row (k = 32): fma(0, 0, a) == a
#pragma unroll
        for (int g = 0; g < RB; g += kWalk) {
          unsigned m[kWalk];
          double a[kWalk];
#pragma unroll
          for (int p = 0; p < kWalk; ++p) {
            m[p] = msk[slot * (RB + 1) + g + p];
            a[p] = acc[g + p];
          }
          for (;;) {
            unsigned any = 0;
#pragma unroll
            for (int p = 0; p < kWalk; ++p) any |= m[p];
            if (!any) break;
            int i[kWalk];
            double dv[kWalk], wv[kWalk];
#pragma unroll
            for (int p = 0; p < kWalk; ++p) {
              i[p] = __clz(m[p]);  // 32 once m[p] is empty
              m[p] &= __funnelshift_rc(0x7fffffffu, 0u, i[p]);
            }
#pragma unroll
            for (int p = 0; p < kWalk; ++p) {
              dv[p] = d[i[p] * kStride + g + p];
              wv[p] = mirror_widen(w[i[p] * 32]);
            }
#pragma unroll
            for (int p = 0; p < kWalk; ++p) {
              a[p] = __fma_rn(dv[p], wv[p], a[p]);
            }
          }
#pragma unroll
          for (int p = 0; p < kWalk; ++p) acc[g + p] = a[p];
        }
      } else {
        // every k of the slice, ascending; all rows, the zeros included
        // (a k no row fired multiplies zeros by a finite stale value)
#pragma unroll 8
        for (int i = 0; i < kMirrorSlice; ++i) {
          const double wv = mirror_widen(w[i * 32]);
          const double* const di = d + i * kStride;
          if constexpr (RB == 1) {
            acc[0] = __fma_rn(di[0], wv, acc[0]);
          } else {
#pragma unroll
            for (int r = 0; r < RB; r += 2) {
              const double2 p = *reinterpret_cast<const double2*>(di + r);
              acc[r] = __fma_rn(p.x, wv, acc[r]);
              acc[r + 1] = __fma_rn(p.y, wv, acc[r + 1]);
            }
          }
        }
      }
    };
    // the launch counters of slice s, from its row masks in the ring:
    // the pass's fired entries, the mirror rows it staged (their union),
    // and their marks; apart from the stage, where registers are dearest
    auto count = [&](int s) {
      const int slot = s % kDepth;
      const unsigned m = lane < RB ? msk[slot * (RB + 1) + lane] : 0u;
      const unsigned live = __brev(__reduce_or_sync(0xffffffffu, m));
      const unsigned fired = __reduce_add_sync(0xffffffffu, __popc(m));
      if ((live >> lane) & 1u) {
        marks[kMirrorSlice * (kMirrorWarps * s + warp) + lane] = 1;
      }
      if (lane == 0) {
        atomicAdd(&counts[kCountFired],
                  static_cast<unsigned long long>(fired));
        atomicAdd(&counts[kCountStaged],
                  static_cast<unsigned long long>(__popc(live)));
      }
    };
    // one step: stage slice s + depth - 1 from v, load v with the deltas
    // of slice s + depth + 1 (two steps ahead), compute slice s
    auto step = [&](float (&v)[RB], int s) {
      if (s + kDepth - 1 < n) stage(v, s + kDepth - 1);
      cp_async_commit();
      if (s + kDepth + 1 < n) load(v, s + kDepth + 1);
      cp_async_wait<kDepth - 1>();  // this lane's copies of slice s landed
      __syncwarp();                 // and every lane's
      if (counting) count(s);
      compute(s);
      __syncwarp();  // slice s is read before its slot is staged again
    };

    {
      float first[kDepth - 1][RB];
#pragma unroll
      for (int s = 0; s < kDepth - 1; ++s) {
        if (s < n) load(first[s], s);
      }
#pragma unroll
      for (int s = 0; s < kDepth - 1; ++s) {
        if (s < n) stage(first[s], s);
        cp_async_commit();
      }
    }
    // the deltas of the next two slices to stage, in turns
    float even[RB], odd[RB];
    if (kDepth - 1 < n) load(even, kDepth - 1);
    if (kDepth < n) load(odd, kDepth);
    for (int s = 0; s < n; s += 2) {
      step(even, s);
      if (s + 1 < n) step(odd, s + 1);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp's walk is done: the ring is free
    double* const part = reinterpret_cast<double*>(mirror_smem);
#pragma unroll
    for (int r = 0; r < RB; ++r) part[(warp * RB + r) * 32 + lane] = acc[r];
    __syncthreads();
    for (int e = threadIdx.x; e < RB * 32; e += kMirrorThreads) {
      const int r = e / 32;
      const int b = b0 + r;
      const int jj = j0 + (e & 31);
      if (b >= B || jj >= N) continue;
      double sum = part[r * 32 + (e & 31)];
      for (int w = 1; w < kMirrorWarps; ++w) {
        sum += part[(w * RB + r) * 32 + (e & 31)];
      }
      float v = __double2float_rn(sum);
      if (scale != nullptr) v = __fmul_rn(v, *scale);
      y[static_cast<size_t>(b) * N + jj] = v;
    }
    __syncthreads();  // the combine has read the partials
  }
}

template <typename W, int RB, bool COUNT>
cudaError_t run_dense_mirror(int device, const float* ds, const W* wt,
                             const float* scale, float* y, int B, int Q,
                             int N, int unit, unsigned long long* counts,
                             unsigned char* marks, cudaStream_t stream) {
  auto kernel = dense_mirror_kernel<W, RB, COUNT>;
  const size_t smem = kMirrorWarps * mirror_warp_bytes(
                                         sizeof(W), RB,
                                         mirror_depth(sizeof(W), RB));
  if (smem > 48 * 1024) {
    // opt in once per device and instantiation
    static bool opted[kMaxDevices] = {};
    if (device < 0 || device >= kMaxDevices || !opted[device]) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) opted[device] = true;
    }
  }
  const dim3 grid((N + 31) / 32);
  kernel<<<grid, kMirrorThreads, smem, stream>>>(ds, wt, scale, y, B, Q, N,
                                                 unit, counts, marks);
  return cudaGetLastError();
}

template <typename W>
int launch_dense_mirror(int device, const float* ds, const W* wt,
                        const float* scale, float* y, int B, int Q, int N,
                        long long* counts_i64, unsigned char* marks,
                        void* stream) {
  auto* const counts = reinterpret_cast<unsigned long long*>(counts_i64);
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || Q < 0 || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || N == 0) return 0;
  const int rows = B < kMirrorMaxRows ? B : kMirrorMaxRows;
  // the widest cp.async every row segment allows (16 or 4 bytes), else
  // plain byte copies (0)
  const uintptr_t a = reinterpret_cast<uintptr_t>(wt);
  const size_t row = static_cast<size_t>(N) * sizeof(W);
  const int unit = row % 16 == 0 && a % 16 == 0 ? 16
                   : row % 4 == 0 && a % 4 == 0 ? 4
                                                : 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define MIRROR_RUN(RR)                                                      \
  if (rows <= RR) {                                                         \
    return static_cast<int>(                                                \
        counts != nullptr                                                   \
            ? run_dense_mirror<W, RR, true>(device, ds, wt, scale, y, B, Q, \
                                            N, unit, counts, marks, st)     \
            : run_dense_mirror<W, RR, false>(device, ds, wt, scale, y, B,   \
                                             Q, N, unit, nullptr, nullptr,  \
                                             st));                          \
  }
  MIRROR_RUN(1)
  MIRROR_RUN(2)
  MIRROR_RUN(4)
  MIRROR_RUN(8)
  MIRROR_RUN(16)
  MIRROR_RUN(32)
#undef MIRROR_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// capacity_clip_topk: the dense route's fired count and capacity clip
//
// Replaces: no Pallas kernel.  It is the count and the clip of
//           src/repro/kernels/ops.py:delta_spmv_dense_topk_batch (n_fired,
//           n_dropped, and clip() under its lax.cond), which the port ran
//           as a chain of 22 PyTorch calls (a multi-block top-k, an int64
//           scan, ...) on every layer-frame: the reference branches on
//           "any row overflowed", and a branch on a device value needs a
//           host sync.
// Computes: for every row b of delta [B, Q], count = #{q : delta != 0}
//           (a float compare, so -0.0 does not fire) and n_dropped[b] =
//           max(count - capacity, 0); and, unless ds is null (k >= Q,
//           where the caller takes delta itself), ds[b] = the chain's
//           where(keep, delta, +0.0), keep = fired & (|delta| > t |
//           (|delta| == t & tie rank <= k - #above)) with t the k-th
//           largest |delta| of the fired entries (topk's order, a NaN
//           above +inf) and ties ranked in index order: the k largest
//           |delta|, boundary ties toward the lower index (the kept set
//           of ops.select_active_columns).  A row with at most k fired
//           entries keeps every finite fired entry (the chain's threshold
//           is then -1 or its least magnitude).  delta is only read.
// Bound:    bytes: the row read once and ds written once, 2 x B x Q x 4
//           bytes (16.8 MB at B = 1024, Q = 2048: ~5 us at 3.35 TB/s).
// Design:   one block per row, the row in registers (8 a thread, strided
//           by the block so loads coalesce, the fewest warps that hold
//           the row, at most 1024 threads; a row past 8 x 1024 is taken a
//           tile at a time and read again for each pass).  A block sum
//           counts the fired entries; a row with at most k of them, the
//           case in served traffic, is written through and the block
//           stops: the reference's lax.cond, taken per row on the device.
//           Otherwise radix select finds t: four passes of 8 bits over
//           the fired magnitudes' bit patterns (a positive float orders
//           as its bits), each a shared-memory histogram of the entries
//           that match the digits so far, one warp picking the digit from
//           the top by a suffix scan.  A block sum counts the entries
//           above t, and the ties are ranked by a ballot a warp and a
//           scan over the warps, one element of each thread at a time in
//           index order.  With counts given (a layer's clip counters,
//           [rows, clipped]), block 0 adds the launch's rows and each
//           clipped row adds one: the launch counters' way, no launch
//           and no sync of their own.
// ---------------------------------------------------------------------------
constexpr int kClipMaxThreads = 1024;
constexpr int kClipE = 8;       // a row's elements a thread
constexpr int kClipBins = 256;  // a digit of 8 bits a pass

// one block a row
__global__ void __launch_bounds__(kClipMaxThreads)
    capacity_clip_topk_kernel(const float* __restrict__ delta,
                              float* __restrict__ ds,
                              int* __restrict__ n_dropped, int Q,
                              int capacity,
                              unsigned long long* __restrict__ counts) {
  const int k = capacity < Q ? capacity : Q;
  __shared__ unsigned hist[kClipBins];
  __shared__ int warp_ties[32];
  __shared__ int row_count;
  __shared__ unsigned pick_digit;
  __shared__ int pick_left;
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int E = kClipE;
  const int tile = E * T;
  const int n_tiles = (Q + tile - 1) / tile;
  const size_t row = static_cast<size_t>(blockIdx.x) * Q;
  float v[E];
  auto load = [&](int t) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t * tile + e * T + threadIdx.x;
      v[e] = i < Q ? delta[row + i] : 0.0f;
    }
  };
  auto index = [&](int t, int e) { return t * tile + e * T + threadIdx.x; };

  load(0);
  int count = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) load(t);
#pragma unroll
    for (int e = 0; e < E; ++e) count += v[e] != 0.0f ? 1 : 0;
  }
  count = block_sum(count);
  if (threadIdx.x == 0) {
    row_count = count;
    n_dropped[blockIdx.x] = count > capacity ? count - capacity : 0;
    if (counts != nullptr) {
      if (blockIdx.x == 0) {
        atomicAdd(&counts[0], static_cast<unsigned long long>(gridDim.x));
      }
      if (count > k) atomicAdd(&counts[1], 1ull);
    }
  }
  __syncthreads();
  if (ds == nullptr) return;
  float* const out = ds + row;
  if (row_count <= k) {
    for (int t = 0; t < n_tiles; ++t) {
      if (n_tiles > 1) load(t);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = index(t, e);
        if (i < Q) out[i] = fabsf(v[e]) > 0.0f ? v[e] : 0.0f;
      }
    }
    return;
  }

  // t: radix select of the k-th largest fired magnitude, from the top
  unsigned prefix = 0, mask = 0;
  int left = k;  // of the entries matching prefix, those still to pass
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int j = threadIdx.x; j < kClipBins; j += T) hist[j] = 0;
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      if (n_tiles > 1) load(t);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned key = __float_as_uint(v[e]) & 0x7fffffffu;
        if (v[e] != 0.0f && (key & mask) == prefix) {
          atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins [8l, 8l + 8); `at` counts the entries in its
      // bins and every bin above them
      unsigned c[8];
      unsigned at = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        at += c[j];
      }
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_down_sync(0xffffffffu, at, off);
        if (lane + off < 32) at += up;
      }
      unsigned higher = __shfl_down_sync(0xffffffffu, at, 1);
      if (lane == 31) higher = 0;
      const unsigned reach =
          __ballot_sync(0xffffffffu, at >= static_cast<unsigned>(left));
      if (lane == 31 - __clz(reach)) {
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (higher + c[j] >= static_cast<unsigned>(left)) {
            pick_digit = 8 * lane + j;
            pick_left = left - static_cast<int>(higher);
            break;
          }
          higher += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= pick_digit << shift;
    mask |= 0xffu << shift;
    left = pick_left;
  }
  const float thr = __uint_as_float(prefix);

  // the chain's keep rule on t: the entries above it, then the ties in
  // index order while k - #above allows
  int above = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (n_tiles > 1) load(t);
#pragma unroll
    for (int e = 0; e < E; ++e) above += fabsf(v[e]) > thr ? 1 : 0;
  }
  above = block_sum(above);
  if (threadIdx.x == 0) row_count = above;
  __syncthreads();
  const int allow = k - row_count;
  const int n_warps = T >> 5;
  int before = 0;  // ties at lower indices
  for (int t = 0; t < n_tiles; ++t) {
    if (n_tiles > 1) load(t);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = index(t, e);
      const float a = fabsf(v[e]);
      const bool tie = i < Q && a == thr;
      const unsigned ties = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) warp_ties[warp] = __popc(ties);
      __syncthreads();
      int rank = before + __popc(ties & ((1u << lane) - 1u));
      for (int w = 0; w < n_warps; ++w) {
        const int n = warp_ties[w];
        if (w < warp) rank += n;
        before += n;
      }
      if (i < Q) out[i] = a > thr || (tie && rank < allow) ? v[e] : 0.0f;
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

const char* spartus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// s = [x | h]: x [B, D], h [B, H] (null when H = 0), s_hat [B, D+H] read,
// s_hat_out written for the rows active selects (may alias s_hat),
// delta [B, D+H] and nnz [B] written for every row; active [B] bools or
// null for all rows.
int spartus_delta_encode_step(int device, const float* x, const float* h,
                              const float* s_hat,
                              const unsigned char* active, float* delta,
                              float* s_hat_out, int* nnz, int B, int D,
                              int H, float theta, int quantize, float scale,
                              float qmin, float qmax, void* stream) {
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int F = D + H;
  if (B == 0) return 0;
  if (B < 0 || D < 0 || H < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_thread = F <= 1024 ? 1 : F <= 2048 ? 2 : 4;
  const int threads = std::min(
      kEncodeMaxThreads,
      std::max(32, ((F + per_thread - 1) / per_thread + 31) / 32 * 32));
  const auto st = static_cast<cudaStream_t>(stream);
#define ENCODE_RUN(EE)                                                      \
  delta_encode_kernel<EE><<<B, threads, 0, st>>>(                           \
      x, h, s_hat, active, delta, s_hat_out, nnz, D, H, theta, quantize,    \
      scale, qmin, qmax)
  if (per_thread <= 1) {
    ENCODE_RUN(1);
  } else if (per_thread <= 2) {
    ENCODE_RUN(2);
  } else {
    ENCODE_RUN(4);
  }
#undef ENCODE_RUN
  return static_cast<int>(cudaGetLastError());
}

// dm [B, 4, H] (gates i, g, f, o), y [B, 4H] or null, c [B, H]; h_out
// [B, H] written for every row; dm_out (or null), c_out and h_state (or
// null) written for the rows active selects (active [B] bools, or null
// for all rows); dm_out may alias dm and c_out may alias c.  marks
// [n_marks] (or null) are counted into *union_count and cleared (the
// launch counters above).
int spartus_lstm_pointwise_step(int device, const float* dm, const float* y,
                                const float* c, const unsigned char* active,
                                float* h_out, float* dm_out, float* c_out,
                                float* h_state, int B, int H,
                                unsigned char* marks, int n_marks,
                                long long* union_count, void* stream) {
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * H;
  if (n == 0) return 0;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest block (<= 256 threads) that still gives every SM a block
  int threads = kPointwiseMaxThreads;
  while (threads > 32 &&
         (n + threads - 1) / threads < static_cast<size_t>(n_sm)) {
    threads /= 2;
  }
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  const auto st = static_cast<cudaStream_t>(stream);
  if (marks != nullptr) {
    lstm_pointwise_kernel<true><<<blocks, threads, 0, st>>>(
        dm, y, c, active, h_out, dm_out, c_out, h_state, B, H, marks,
        n_marks, reinterpret_cast<unsigned long long*>(union_count));
  } else {
    lstm_pointwise_kernel<false><<<blocks, threads, 0, st>>>(
        dm, y, c, active, h_out, dm_out, c_out, h_state, B, H, nullptr, 0,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts and marks: one layer's counters (the launch counters above), or
// null.
#define SPARTUS_SPMV_ENTRY(NAME, V, L)                                        \
  int NAME(int device, const void* val, const void* lidx, const int* idx,    \
           const float* ds, float* y, int B, int K, int Q, int M, int BLEN,  \
           int S, long long* counts, unsigned char* marks, void* stream) {   \
    return launch_stsp_spmv<V, L>(device, val, lidx, idx, ds, y, B, K, Q, M, \
                                  BLEN, S, counts, marks, stream);           \
  }

SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_f32_i32, float, int32_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_f32_i8, float, int8_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_i8_i32, int8_t, int32_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_i8_i8, int8_t, int8_t)

#undef SPARTUS_SPMV_ENTRY

// ds [B, Q] fp32, wt [Q, N] fp32 or int8, scale a device float or null,
// y [B, N] written; counts and marks: one layer's counters (the launch
// counters above), or null.
int spartus_dense_mirror_f32(int device, const float* ds, const float* wt,
                             const float* scale, float* y, int B, int Q,
                             int N, long long* counts, unsigned char* marks,
                             void* stream) {
  return launch_dense_mirror<float>(device, ds, wt, scale, y, B, Q, N,
                                    counts, marks, stream);
}

int spartus_dense_mirror_i8(int device, const float* ds, const int8_t* wt,
                            const float* scale, float* y, int B, int Q,
                            int N, long long* counts, unsigned char* marks,
                            void* stream) {
  return launch_dense_mirror<int8_t>(device, ds, wt, scale, y, B, Q, N,
                                     counts, marks, stream);
}

// delta [B, Q] read; n_dropped [B] written; ds [B, Q] written, or null
// where the caller takes delta itself (capacity >= Q: only the counts);
// capacity >= 1 where ds is given; counts: a layer's clip counters [rows,
// clipped] (the launch counters above), or null.
int spartus_capacity_clip_topk(int device, const float* delta, float* ds,
                               int* n_dropped, int B, int Q, int capacity,
                               long long* counts, void* stream) {
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || Q < 0 || capacity < 0 || (ds != nullptr && capacity < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  auto* const c = reinterpret_cast<unsigned long long*>(counts);
  const auto st = static_cast<cudaStream_t>(stream);
  const int threads =
      std::min(kClipMaxThreads,
               std::max(32, ((Q + kClipE - 1) / kClipE + 31) / 32 * 32));
  capacity_clip_topk_kernel<<<B, threads, 0, st>>>(delta, ds, n_dropped, Q,
                                                   capacity, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels of the Spartus datapath: the CUDA
// ports of the four Pallas TPU kernels of src/repro/kernels/.
//
// Plain C interface, bound from Python with ctypes
// (src/repro_torch/kernels/_build.py).  Every entry point takes the CUDA
// device index first and the stream last, launches on that stream (the
// caller passes PyTorch's current stream), allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// Arithmetic that feeds the recurrence is written with explicit
// round-to-nearest intrinsics (__fmul_rn / __fadd_rn) so nvcc cannot fuse
// it into FMAs: each kernel then rounds where its plain PyTorch version
// (src/repro_torch/kernels/ref.py) rounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kEncodeThreads = 256;
constexpr int kPointwiseThreads = 256;

// ---------------------------------------------------------------------------
// delta_encode
//
// Replaces: src/repro/kernels/delta_encode.py:delta_encode_pallas
//           (body _delta_encode_kernel), vmapped over slots by
//           ops.delta_encode_batch.
// Computes: eqs. (4)-(5) of the paper for every slot b of a [B, F] state:
//           delta = where(|x - x_hat| > theta, x - x_hat, 0),
//           x_hat' = where(fired, x, x_hat), nnz[b] = number fired.  With
//           `quantize`, x is first snapped to the Qm.n grid
//           (clip(rint(x / scale), qmin, qmax) * scale); theta arrives
//           snapped by the wrapper.
// Bound:    bytes.  Four fp32 streams of B*F (two read, two written) and
//           one flop-free compare per element; at the serving shapes
//           (B=16, F<=2048) the 0.5 MB it moves takes ~0.2 us at
//           3.35 TB/s, so a launch is latency bound.
// Design:   one block per slot row, threads striding over F with
//           coalesced loads and stores, the fired count reduced in
//           registers, then warp shuffles and one shared-memory pass:
//           one launch for the whole pool, no atomics, no 1024-element
//           padding contract (the TPU tile needed one; this loop masks
//           the ragged tail itself).
// ---------------------------------------------------------------------------
__global__ void delta_encode_kernel(const float* __restrict__ x,
                                    const float* __restrict__ x_hat,
                                    float* __restrict__ delta,
                                    float* __restrict__ x_hat_out,
                                    int* __restrict__ nnz, int F,
                                    float theta, int quantize, float scale,
                                    float qmin, float qmax) {
  const size_t row = static_cast<size_t>(blockIdx.x) * F;
  int count = 0;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    float v = x[row + i];
    if (quantize) {
      // scale is a power of two: the division and product are exact
      v = __fmul_rn(fminf(fmaxf(rintf(v / scale), qmin), qmax), scale);
    }
    const float h = x_hat[row + i];
    const float raw = __fsub_rn(v, h);
    const bool fired = fabsf(raw) > theta;
    delta[row + i] = fired ? raw : 0.0f;
    x_hat_out[row + i] = fired ? v : h;
    count += fired ? 1 : 0;
  }
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
    if (lane == 0) nnz[blockIdx.x] = count;
  }
}

// ---------------------------------------------------------------------------
// lstm_pointwise
//
// Replaces: src/repro/kernels/lstm_pointwise.py:lstm_pointwise_pallas
//           (body _lstm_pointwise_kernel), vmapped over slots by
//           ops.lstm_pointwise_batch.
// Computes: the HPE gate math on dm [B, 4, H] in (i, g, f, o) order:
//           c' = sigmoid(f) * c + sigmoid(i) * tanh(g),
//           h = sigmoid(o) * tanh(c').
// Bound:    bytes.  Reads 5 and writes 2 fp32 values per (slot, unit):
//           0.46 MB at B=16, H=1024, ~0.14 us at 3.35 TB/s; the few dozen
//           flops per element are far below the compute rates, so a
//           launch is latency bound.
// Design:   one thread per (slot, unit), a grid-stride loop; each gate
//           row is read with unit-stride (coalesced) loads, the five
//           inputs stay in registers, and the cell state never makes a
//           second trip to memory.  sigmoid and tanh run in double and
//           round to float: the correctly rounded value (barring a
//           near-tie), bit-identical to the plain version on the host and
//           on the card, where float library versions differ by an ulp
//           that the delta thresholds downstream would amplify.  The five
//           double transcendentals per element stay far below the card's
//           fp64 rate at these sizes.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float sigmoid_rn(float v) {
  return static_cast<float>(1.0 / (1.0 + exp(-static_cast<double>(v))));
}

__device__ __forceinline__ float tanh_rn(float v) {
  return static_cast<float>(tanh(static_cast<double>(v)));
}

__global__ void lstm_pointwise_kernel(const float* __restrict__ dm,
                                      const float* __restrict__ c,
                                      float* __restrict__ h,
                                      float* __restrict__ c_out, int B,
                                      int H) {
  const size_t n = static_cast<size_t>(B) * H;
  for (size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = t / H;
    const size_t j = t - b * H;
    const float* d = dm + b * 4 * H + j;
    const float gi = sigmoid_rn(d[0]);
    const float gg = tanh_rn(d[H]);
    const float gf = sigmoid_rn(d[2 * static_cast<size_t>(H)]);
    const float go = sigmoid_rn(d[3 * static_cast<size_t>(H)]);
    const float cn = __fadd_rn(__fmul_rn(gf, c[t]), __fmul_rn(gi, gg));
    c_out[t] = cn;
    h[t] = __fmul_rn(go, tanh_rn(cn));
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

// R = row registers per lane (>= ceil(S/16)); BLEN_C = 4 reads a PE's
// pairs with one vector load per array, 0 loops over a runtime BLEN.
// grid (B, M / P), blockDim.x = 32 * ceil(P / 2): half-warp h of warp w
// serves PE pe0 + 2w + h.  Dynamic shared memory holds one region per
// warp: live ds [2][T] | val [2][T][2 PEs][BLEN] | lidx [2][T][2][BLEN];
// at the end it is reused for the block's [S][P] output.
template <typename V, typename L, int R, int BLEN_C>
__global__ void __launch_bounds__(32 * kSpmvMaxWarps)
    stsp_spmv_kernel(const V* __restrict__ val, const L* __restrict__ lidx,
                     const int* __restrict__ idx,
                     const float* __restrict__ ds, float* __restrict__ y,
                     int K, int Q, int M, int BLEN, int S, int P, int T,
                     int unit_v, int unit_l) {
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
                          int P, int T, int unit_v, int unit_l) {
  auto kernel = stsp_spmv_kernel<V, L, R, BLEN_C>;
  if (smem > 48 * 1024) {
    // opt in once per device, to the most any launch can ask for
    static bool opted[kMaxDevices] = {};
    if (device < 0 || device >= kMaxDevices || !opted[device]) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSpmvSmemBudget);
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) opted[device] = true;
    }
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const V*>(val), static_cast<const L*>(lidx), idx, ds, y, K,
      Q, M, BLEN, S, P, T, unit_v, unit_l);
  return cudaGetLastError();
}

template <typename V, typename L>
int launch_stsp_spmv(int device, const void* val, const void* lidx,
                     const int* idx, const float* ds, float* y, int B, int K,
                     int Q, int M, int BLEN, int S, void* stream) {
  constexpr int kMaxRows = kSpmvLanes * kSpmvMaxRowRegs;
  cudaError_t err = cudaSetDevice(device);
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
                                           unit_l)                            \
              : run_stsp_spmv<V, L, RR, 0>(device, grid, threads, smem, st,   \
                                           val, lidx, idx, ds, y, K, Q, M,    \
                                           BLEN, S, pes, tile, unit_v,        \
                                           unit_l);                           \
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

}  // namespace

extern "C" {

const char* spartus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int spartus_delta_encode(int device, const float* x, const float* x_hat,
                         float* delta, float* x_hat_out, int* nnz, int B,
                         int F, float theta, int quantize, float scale,
                         float qmin, float qmax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  delta_encode_kernel<<<B, kEncodeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, x_hat, delta, x_hat_out, nnz, F, theta, quantize, scale, qmin, qmax);
  return static_cast<int>(cudaGetLastError());
}

int spartus_lstm_pointwise(int device, const float* dm, const float* c,
                           float* h, float* c_out, int B, int H,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * H;
  if (n == 0) return 0;
  const size_t want = (n + kPointwiseThreads - 1) / kPointwiseThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  lstm_pointwise_kernel<<<blocks, kPointwiseThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(dm, c, h, c_out,
                                                               B, H);
  return static_cast<int>(cudaGetLastError());
}

#define SPARTUS_SPMV_ENTRY(NAME, V, L)                                        \
  int NAME(int device, const void* val, const void* lidx, const int* idx,    \
           const float* ds, float* y, int B, int K, int Q, int M, int BLEN,  \
           int S, void* stream) {                                            \
    return launch_stsp_spmv<V, L>(device, val, lidx, idx, ds, y, B, K, Q, M, \
                                  BLEN, S, stream);                          \
  }

SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_f32_i32, float, int32_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_f32_i8, float, int8_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_i8_i32, int8_t, int32_t)
SPARTUS_SPMV_ENTRY(spartus_stsp_spmv_i8_i8, int8_t, int8_t)

#undef SPARTUS_SPMV_ENTRY

}  // extern "C"

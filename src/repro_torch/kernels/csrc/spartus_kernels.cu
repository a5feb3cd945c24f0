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

namespace {

constexpr int kEncodeThreads = 256;
constexpr int kPointwiseThreads = 256;
constexpr int kSpmvTile = 256;  // NZI list entries staged per shared tile

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
//           columns accumulate; ds = 0 entries (the list's padding) add
//           nothing.  val is fp32 or int8 (its scale is applied by the
//           caller on the [B, S*M] output), lidx int32 or int8.
// Bound:    bytes, and data dependent: per active entry one [M, BLEN]
//           slab of val and of lidx (2 KB fp32 / 512 B int8 at M=64,
//           BLEN=4), plus the [B, K] list and the [B, S*M] output.  Two
//           flops per fetched pair; far from any compute limit.
// Design:   one block per slot, one thread per PE, so thread pe owns the
//           rows r = pe (mod M) of an [S, M] fp32 accumulator in shared
//           memory (16 KB at 4H = 4096): no two threads ever touch one
//           row, so there are no atomics, and the sum for a row runs in
//           list order, exactly as the plain scatter-add adds it.  The
//           [B, K] list is staged through shared memory a tile at a
//           time; each thread reads its PE's BLEN contiguous (value,
//           lidx) pairs, so a warp's slab loads are coalesced.  lidx is
//           widened to int32 before the row math.  y is written once.
//           Simple and deterministic; splitting K across warps or
//           prefetching slabs with TMA is later work.
// ---------------------------------------------------------------------------
template <typename V, typename L>
__global__ void stsp_spmv_kernel(const V* __restrict__ val,
                                 const L* __restrict__ lidx,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ ds,
                                 float* __restrict__ y, int K, int Q, int M,
                                 int BLEN, int S) {
  extern __shared__ float smem[];
  float* acc = smem;                                         // [S, M]
  int* s_idx = reinterpret_cast<int*>(acc + static_cast<size_t>(S) * M);
  float* s_ds = reinterpret_cast<float*>(s_idx + kSpmvTile);
  const int b = blockIdx.x;
  const int pe = threadIdx.x;
  for (int r = 0; r < S; ++r) acc[r * M + pe] = 0.0f;
  const int* idx_b = idx + static_cast<size_t>(b) * K;
  const float* ds_b = ds + static_cast<size_t>(b) * K;
  for (int k0 = 0; k0 < K; k0 += kSpmvTile) {
    const int n = min(kSpmvTile, K - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int t = pe; t < n; t += M) {
      s_idx[t] = idx_b[k0 + t];
      s_ds[t] = ds_b[k0 + t];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float d = s_ds[t];
      const int col = s_idx[t];
      if (d == 0.0f || col < 0 || col >= Q) continue;
      const size_t base = (static_cast<size_t>(col) * M + pe) * BLEN;
      for (int j = 0; j < BLEN; ++j) {
        const int l = static_cast<int>(lidx[base + j]);
        if (static_cast<unsigned>(l) < static_cast<unsigned>(S)) {
          float* a = acc + l * M + pe;
          *a = __fadd_rn(*a, __fmul_rn(d, static_cast<float>(val[base + j])));
        }
      }
    }
  }
  // each thread reads back only the rows it wrote: no barrier needed
  float* y_b = y + static_cast<size_t>(b) * S * M;
  for (int r = 0; r < S; ++r) y_b[r * M + pe] = acc[r * M + pe];
}

template <typename V, typename L>
int launch_stsp_spmv(int device, const void* val, const void* lidx,
                     const int* idx, const float* ds, float* y, int B, int K,
                     int Q, int M, int BLEN, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (M < 1 || M > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(S) * M * sizeof(float) +
                      kSpmvTile * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stsp_spmv_kernel<V, L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stsp_spmv_kernel<V, L><<<B, M, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(val), static_cast<const L*>(lidx), idx, ds, y, K,
      Q, M, BLEN, S);
  return static_cast<int>(cudaGetLastError());
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

// SpMM  out = A @ x  for Hopper (sm_90a) over the nonzeros of a BSR plan.
//
// Two kernels, one for each of the TPU kernels in
// ctgcn_tpu/ops/pallas_spmm.py:
//   rowwalk   replaces _spmm_kernel (:97): a warp walks an output row;
//   blockpar  replaces _spmm_v2_kernel (:146): a grid over equal chunks of
//             the nonzero stream, in two passes.
// The TPU kernels multiply whole 128x128 blocks.  On the UCI k-core pyramid
// a block holds about 62 nonzeros (0.38 % fill), so block products do some
// 260x the work the product needs; even at the TF32 tensor-core peak, or
// 3xTF32 for FP32 parity, they take no less than torch.sparse.mm.  These
// kernels read and multiply only the plan's nonzeros, which the plan keeps
// in CSR beside its blocks (ctgcn_torch/ops/bsr_spmm.py).
//
// What bounds them on the card: bytes.  The product does 2 * nnz * d FLOPs
// against (col, val) per nonzero, x read once and out written once.  A
// gather kernel moves more than that bound counts: one x row per nonzero
// from L2 (400 MB at d = 512 on UCI, against 68 MB to and from HBM), so
// the design moves no byte it need not, finds repeats in L1, and keeps many
// loads in flight:
//   * a warp covers 128 * NV columns of an output row, NV = 1 or 2 float4
//     per lane; wider d takes more CUDA blocks along grid y;
//   * (col, val) pairs are read 32 at a time as coalesced loads and
//     broadcast with __shfl_sync; x rows are gathered as 16-byte read-only
//     loads (__ldg), LOADS / NV nonzeros at a time;
//   * the row walk takes rows in the plan's walk order, which puts rows
//     that share columns (one node's core slots) in one CUDA block, so its
//     warps find each other's x rows in L1;
//   * FP32 FFMA in registers (no TF32), nonzeros in column order within a
//     walker, partial sums added in a fixed order: deterministic, and no
//     atomics anywhere;
//   * out is written once, with evict-first stores (__stcs), so the output
//     does not push x (3.9 MB in the forward) out of the 50 MB L2;
//   * the block-parallel kernel's second pass is a programmatic dependent
//     launch: it starts during the first pass's last wave and waits
//     (griddepcontrol.wait) only where it reads the first pass's scratch;
//   * no shared-memory staging of x tiles (a staged row would be used about
//     0.5 times), and no wgmma, TMA or 3xTF32: operations do not bound it.
//
// C interface for ctypes: every pointer and the stream is a void*, every
// call returns the first CUDA error of its launches, so a refused launch is
// reported.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WARPS = 8;              // warps per CUDA block
constexpr int THREADS = WARPS * 32;
constexpr int LOADS = 8;              // x loads in flight per lane
constexpr unsigned FULL = 0xffffffffu;

// A lane's columns of its warp's d slice: c0 + 128 * k, k < NV.
template <int NV>
__device__ __forceinline__ void zero(float4 (&acc)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int NV>
__device__ __forceinline__ void load_row(float4 (&v)[NV],
                                         const float* __restrict__ src,
                                         int d, int c0, bool on) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + 128 * k;
    v[k] = (on && c < d) ? __ldg(reinterpret_cast<const float4*>(src + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NV>
__device__ __forceinline__ void fma_row(float4 (&acc)[NV], float w,
                                        const float4 (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    acc[k].x = __fmaf_rn(w, v[k].x, acc[k].x);
    acc[k].y = __fmaf_rn(w, v[k].y, acc[k].y);
    acc[k].z = __fmaf_rn(w, v[k].z, acc[k].z);
    acc[k].w = __fmaf_rn(w, v[k].w, acc[k].w);
  }
}

// STREAM: evict-first (the final output); else a plain store (scratch that
// pass 2 reads back from L2).
template <int NV, bool STREAM>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float4 (&acc)[NV], int d,
                                          int c0) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + 128 * k;
    if (c < d) {
      float4* p = reinterpret_cast<float4*>(dst + c);
      if (STREAM)
        __stcs(p, acc[k]);
      else
        *p = acc[k];
    }
  }
}

// Counterpart of _spmm_kernel.  Warp `pos` walks row order[pos]: acc +=
// val[j] * x[col[j], lane's columns] over the row's nonzeros in column
// order, then the row is stored once (zeros for an empty row).
template <int NV>
__global__ void __launch_bounds__(THREADS)
rowwalk_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ val, const int* __restrict__ order,
               const float* __restrict__ x, float* __restrict__ out,
               int n_rows, int d) {
  constexpr int U = LOADS / NV;  // divides 32, so t + u < 32 below
  const int lane = threadIdx.x & 31;
  const int pos = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pos >= n_rows) return;
  const int r = __ldg(order + pos);
  const int c0 = blockIdx.y * 128 * NV + 4 * lane;
  const int p1 = __ldg(ptr + r + 1);
  float4 acc[NV];
  zero<NV>(acc);
  for (int base = __ldg(ptr + r); base < p1; base += 32) {
    const int n = min(32, p1 - base);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = __ldg(val + base + lane);
    }
    for (int t = 0; t < n; t += U) {
      float4 xv[U][NV];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(FULL, my_col, t + u);
        w[u] = __shfl_sync(FULL, my_val, t + u);
        load_row<NV>(xv[u], x + static_cast<size_t>(c) * d, d, c0, t + u < n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t + u < n) fma_row<NV>(acc, w[u], xv[u]);
    }
  }
  store_row<NV, true>(out + static_cast<size_t>(r) * d, acc, d, c0);
}

// Counterpart of _spmm_v2_kernel, pass 1.  Warp c takes nonzeros
// [c * chunk, (c + 1) * chunk) in row order.  A row that lies wholly inside
// the chunk goes straight to out.  A row that crosses the chunk's edge
// leaves its piece in scratch row 2c + slot: slot 0 for the row that holds
// the chunk's first nonzero, slot 1 for the row that holds its last (when
// another row); a row that starts at or before the chunk's start takes
// slot 0.
template <int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_chunk_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ nz_row,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const float* __restrict__ x,
                      float* __restrict__ scratch, float* __restrict__ out,
                      int nnz, int chunk, int d) {
  constexpr int U = LOADS / NV;
  // pass 2 may start once every CUDA block of this pass has: its empty
  // rows need nothing from here, and it waits before reading scratch
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= (nnz + chunk - 1) / chunk) return;
  const int start = c * chunk;
  const int end = min(nnz, start + chunk);
  const int c0 = blockIdx.y * 128 * NV + 4 * lane;
  auto flush = [&](int row, const float4 (&acc)[NV]) {
    const int p0 = __ldg(ptr + row);
    const int p1 = __ldg(ptr + row + 1);
    if (p0 >= start && p1 <= end)
      store_row<NV, true>(out + static_cast<size_t>(row) * d, acc, d, c0);
    else
      store_row<NV, false>(
          scratch + static_cast<size_t>(2 * c + (p0 > start)) * d, acc, d,
          c0);
  };
  float4 acc[NV];
  zero<NV>(acc);
  int cur = __ldg(nz_row + start);
  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_col = 0, my_row = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = __ldg(val + base + lane);
      my_row = __ldg(nz_row + base + lane);
    }
    for (int t = 0; t < n; t += U) {
      float4 xv[U][NV];
      float w[U];
      int rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cc = __shfl_sync(FULL, my_col, t + u);
        w[u] = __shfl_sync(FULL, my_val, t + u);
        rows[u] = __shfl_sync(FULL, my_row, t + u);
        load_row<NV>(xv[u], x + static_cast<size_t>(cc) * d, d, c0,
                     t + u < n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u < n) {
          if (rows[u] != cur) {
            flush(cur, acc);
            zero<NV>(acc);
            cur = rows[u];
          }
          fma_row<NV>(acc, w[u], xv[u]);
        }
      }
    }
  }
  flush(cur, acc);
}

// Pass 2: one warp per output row, launched as a programmatic dependent of
// pass 1, so that it starts during pass 1's last wave.  An empty row is
// written as zeros at once; a row inside one chunk was written by pass 1;
// a row across chunks k0 .. k1 waits for pass 1, then adds its pieces in
// chunk order (deterministic, no atomics): slot (p0 > k0 * chunk) of chunk
// k0, then slot 0 of each later chunk, U pieces in flight at a time (a hub
// row has tens of them).
template <int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_rows_kernel(const int* __restrict__ ptr,
                     const float* __restrict__ scratch,
                     float* __restrict__ out, int n_rows, int chunk, int d) {
  constexpr int U = LOADS / NV;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int c0 = blockIdx.y * 128 * NV + 4 * (threadIdx.x & 31);
  const int p0 = __ldg(ptr + r);
  const int p1 = __ldg(ptr + r + 1);
  float4 acc[NV];
  zero<NV>(acc);
  if (p0 < p1) {
    const int k0 = p0 / chunk;
    const int k1 = (p1 - 1) / chunk;
    if (k0 == k1) return;
    // pass 1 has finished and its scratch is visible
    asm volatile("griddepcontrol.wait;" ::: "memory");
    float4 v[U][NV];
    load_row<NV>(v[0],
                 scratch + static_cast<size_t>(2 * k0 + (p0 > k0 * chunk)) * d,
                 d, c0, true);
    fma_row<NV>(acc, 1.0f, v[0]);
    for (int k = k0 + 1; k <= k1; k += U) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_row<NV>(v[u], scratch + static_cast<size_t>(2 * (k + u)) * d, d,
                     c0, k + u <= k1);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u <= k1) fma_row<NV>(acc, 1.0f, v[u]);
    }
  }
  store_row<NV, true>(out + static_cast<size_t>(r) * d, acc, d, c0);
}

// float4 per lane: a warp covers 128 columns of d up to d = 128, else 256
int vec_per_lane(int d) { return d <= 128 ? 1 : 2; }

dim3 grid_for(long long items, int d, int nv) {
  return dim3(static_cast<unsigned>((items + WARPS - 1) / WARPS),
              static_cast<unsigned>((d + 128 * nv - 1) / (128 * nv)));
}

template <int NV>
cudaError_t launch_rowwalk(const int* ptr, const int* col, const float* val,
                           const int* order, const float* x, float* out,
                           int n_rows, int d, cudaStream_t st) {
  rowwalk_kernel<NV><<<grid_for(n_rows, d, NV), THREADS, 0, st>>>(
      ptr, col, val, order, x, out, n_rows, d);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_blockpar(const int* ptr, const int* nz_row,
                            const int* col, const float* val, const float* x,
                            float* scratch, float* out, int n_rows, int nnz,
                            int chunk, int d, cudaStream_t st) {
  if (nnz > 0) {
    blockpar_chunk_kernel<NV>
        <<<grid_for((nnz + chunk - 1) / chunk, d, NV), THREADS, 0, st>>>(
            ptr, nz_row, col, val, x, scratch, out, nnz, chunk, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_for(n_rows, d, NV);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, blockpar_rows_kernel<NV>, ptr,
                            static_cast<const float*>(scratch), out, n_rows,
                            chunk, d);
}

}  // namespace

extern "C" int bsr_spmm_rowwalk(const void* ptr, const void* col,
                                const void* val, const void* order,
                                const void* x, void* out, int n_rows, int d,
                                void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int*>(ptr);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* od = static_cast<const int*>(order);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_per_lane(d) == 1
          ? launch_rowwalk<1>(p, c, v, od, xx, o, n_rows, d, st)
          : launch_rowwalk<2>(p, c, v, od, xx, o, n_rows, d, st));
}

extern "C" int bsr_spmm_blockpar(const void* ptr, const void* nz_row,
                                 const void* col, const void* val,
                                 const void* x, void* scratch, void* out,
                                 int n_rows, int nnz, int chunk, int d,
                                 void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int*>(ptr);
  const auto* zr = static_cast<const int*>(nz_row);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* xx = static_cast<const float*>(x);
  auto* s = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_per_lane(d) == 1
          ? launch_blockpar<1>(p, zr, c, v, xx, s, o, n_rows, nnz, chunk, d,
                               st)
          : launch_blockpar<2>(p, zr, c, v, xx, s, o, n_rows, nnz, chunk, d,
                               st));
}

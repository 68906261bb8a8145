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
// Each kernel is a template on the element types of x and of out, with
// three instantiations: f32 -> f32, and for x in bf16 (the JAX package's
// ``ell_spmm(..., bf16=True)``, ctgcn_tpu/ops/ell.py:184-207) bf16 -> bf16
// for the forward (the slot products it stores in bf16) and bf16 -> f32 for
// the backward (dx in f32).  A bf16 kernel rounds each value to bf16 as it
// loads it (JAX casts the values to the gather's dtype), multiplies and sums
// in f32, and rounds once, at the store, when out is bf16.
//
// What bounds them on the card: bytes.  The product does 2 * nnz * d FLOPs
// against (col, val) per nonzero, x read once and out written once.  A
// gather kernel moves more than that bound counts: one x row per nonzero
// from L2 (400 MB at d = 512 on UCI, against 68 MB to and from HBM), so
// the design moves no byte it need not, finds repeats in L1, and keeps many
// loads in flight:
//   * a lane moves 16 bytes of an x row per load (4 f32 or 8 bf16 values),
//     so a warp covers 32 * VEC * NV columns of an output row, NV = 1 or 2
//     loads per lane; wider d takes more CUDA blocks along grid y.  bf16
//     halves the gathered bytes, and the forward's writes;
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
//     (griddepcontrol.wait) only where it reads the first pass's scratch,
//     which holds f32 partial sums whatever the element types;
//   * no shared-memory staging of x tiles (a staged row would be used about
//     0.5 times), and no wgmma, TMA or 3xTF32: operations do not bound it.
//
// C interface for ctypes: every pointer and the stream is a void*, every
// call returns the first CUDA error of its launches, so a refused launch is
// reported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WARPS = 8;              // warps per CUDA block
constexpr int THREADS = WARPS * 32;
constexpr int LOADS = 8;              // x loads in flight per lane
constexpr unsigned FULL = 0xffffffffu;

// VEC: the values of T in one 16-byte load
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float round(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // round to nearest even, as JAX's astype(bfloat16)
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// One lane's columns of its warp's d slice: c0 + 32 * VEC * k, k < NV,
// VEC values from each.
template <int NV, int VEC>
using Acc = float[NV][VEC];

template <int NV, int VEC>
__device__ __forceinline__ void zero(Acc<NV, VEC>& acc) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
}

// 16 bytes of T per column group, kept raw until the FMA
template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&v)[NV],
                                         const T* __restrict__ src, int d,
                                         int c0, bool on) {
  constexpr int VEC = Elem<T>::VEC;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + 32 * VEC * k;
    v[k] = (on && c < d) ? __ldg(reinterpret_cast<const uint4*>(src + c))
                         : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The VEC values of one 16-byte load as floats
template <typename T>
__device__ __forceinline__ void unpack(float (&f)[Elem<T>::VEC], uint4 r);
template <>
__device__ __forceinline__ void unpack<float>(float (&f)[4], uint4 r) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(float (&f)[8],
                                                      uint4 r) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the value at the lower address is the low half
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <typename T, int NV>
__device__ __forceinline__ void fma_row(Acc<NV, Elem<T>::VEC>& acc, float w,
                                        const uint4 (&v)[NV]) {
  constexpr int VEC = Elem<T>::VEC;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float f[VEC];
    unpack<T>(f, v[k]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = __fmaf_rn(w, f[j], acc[k][j]);
  }
}

// f32 values of the VEC columns at c as float4 pieces (pass 2's scratch)
template <int NV, int VEC>
__device__ __forceinline__ void load_acc(Acc<NV, VEC>& v,
                                         const float* __restrict__ src,
                                         int d, int c0, bool on) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + 32 * VEC * k;
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 p = (on && c < d)
          ? __ldg(reinterpret_cast<const float4*>(src + c) + q)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[k][4 * q] = p.x;
      v[k][4 * q + 1] = p.y;
      v[k][4 * q + 2] = p.z;
      v[k][4 * q + 3] = p.w;
    }
  }
}

template <int NV, int VEC>
__device__ __forceinline__ void add_acc(Acc<NV, VEC>& acc,
                                        const Acc<NV, VEC>& v) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] += v[k][j];
}

template <bool STREAM, typename V>
__device__ __forceinline__ void store16(V* p, V v) {
  if (STREAM)
    __stcs(p, v);
  else
    *p = v;
}

// STREAM: evict-first (the final output); else a plain store (scratch that
// pass 2 reads back from L2).  TO = float: VEC / 4 float4 stores; TO =
// bf16: VEC / 8 stores of 8 values, each rounded once.
template <typename TO, int NV, int VEC, bool STREAM>
__device__ __forceinline__ void store_row(TO* __restrict__ dst,
                                          const Acc<NV, VEC>& acc, int d,
                                          int c0) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + 32 * VEC * k;
    if (c >= d) continue;
    if constexpr (sizeof(TO) == 4) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        store16<STREAM>(reinterpret_cast<float4*>(dst + c) + q,
                        make_float4(acc[k][4 * q], acc[k][4 * q + 1],
                                    acc[k][4 * q + 2], acc[k][4 * q + 3]));
    } else {
      static_assert(VEC % 8 == 0, "bf16 out needs 8 values per lane");
#pragma unroll
      for (int q = 0; q < VEC / 8; ++q) {
        unsigned u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              acc[k][8 * q + 2 * i], acc[k][8 * q + 2 * i + 1]);
          u[i] = *reinterpret_cast<const unsigned*>(&h);
        }
        store16<STREAM>(reinterpret_cast<uint4*>(dst + c) + q,
                        make_uint4(u[0], u[1], u[2], u[3]));
      }
    }
  }
}

// Counterpart of _spmm_kernel.  Warp `pos` walks row order[pos]: acc +=
// val[j] * x[col[j], lane's columns] over the row's nonzeros in column
// order, then the row is stored once (zeros for an empty row).
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
rowwalk_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ val, const int* __restrict__ order,
               const TI* __restrict__ x, TO* __restrict__ out, int n_rows,
               int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = LOADS / NV;  // divides 32, so t + u < 32 below
  const int lane = threadIdx.x & 31;
  const int pos = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pos >= n_rows) return;
  const int r = __ldg(order + pos);
  const int c0 = blockIdx.y * 32 * VEC * NV + VEC * lane;
  const int p1 = __ldg(ptr + r + 1);
  Acc<NV, VEC> acc;
  zero<NV, VEC>(acc);
  for (int base = __ldg(ptr + r); base < p1; base += 32) {
    const int n = min(32, p1 - base);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = Elem<TI>::round(__ldg(val + base + lane));
    }
    for (int t = 0; t < n; t += U) {
      uint4 xv[U][NV];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(FULL, my_col, t + u);
        w[u] = __shfl_sync(FULL, my_val, t + u);
        load_row<TI, NV>(xv[u], x + static_cast<size_t>(c) * d, d, c0,
                         t + u < n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t + u < n) fma_row<TI, NV>(acc, w[u], xv[u]);
    }
  }
  store_row<TO, NV, VEC, true>(out + static_cast<size_t>(r) * d, acc, d, c0);
}

// Counterpart of _spmm_v2_kernel, pass 1.  Warp c takes nonzeros
// [c * chunk, (c + 1) * chunk) in row order.  A row that lies wholly inside
// the chunk goes straight to out.  A row that crosses the chunk's edge
// leaves its piece (f32) in scratch row 2c + slot: slot 0 for the row that
// holds the chunk's first nonzero, slot 1 for the row that holds its last
// (when another row); a row that starts at or before the chunk's start
// takes slot 0.
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_chunk_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ nz_row,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const TI* __restrict__ x,
                      float* __restrict__ scratch, TO* __restrict__ out,
                      int nnz, int chunk, int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = LOADS / NV;
  // pass 2 may start once every CUDA block of this pass has: its empty
  // rows need nothing from here, and it waits before reading scratch
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= (nnz + chunk - 1) / chunk) return;
  const int start = c * chunk;
  const int end = min(nnz, start + chunk);
  const int c0 = blockIdx.y * 32 * VEC * NV + VEC * lane;
  auto flush = [&](int row, const Acc<NV, VEC>& acc) {
    const int p0 = __ldg(ptr + row);
    const int p1 = __ldg(ptr + row + 1);
    if (p0 >= start && p1 <= end)
      store_row<TO, NV, VEC, true>(out + static_cast<size_t>(row) * d, acc,
                                   d, c0);
    else
      store_row<float, NV, VEC, false>(
          scratch + static_cast<size_t>(2 * c + (p0 > start)) * d, acc, d,
          c0);
  };
  Acc<NV, VEC> acc;
  zero<NV, VEC>(acc);
  int cur = __ldg(nz_row + start);
  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_col = 0, my_row = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = Elem<TI>::round(__ldg(val + base + lane));
      my_row = __ldg(nz_row + base + lane);
    }
    for (int t = 0; t < n; t += U) {
      uint4 xv[U][NV];
      float w[U];
      int rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cc = __shfl_sync(FULL, my_col, t + u);
        w[u] = __shfl_sync(FULL, my_val, t + u);
        rows[u] = __shfl_sync(FULL, my_row, t + u);
        load_row<TI, NV>(xv[u], x + static_cast<size_t>(cc) * d, d, c0,
                         t + u < n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u < n) {
          if (rows[u] != cur) {
            flush(cur, acc);
            zero<NV, VEC>(acc);
            cur = rows[u];
          }
          fma_row<TI, NV>(acc, w[u], xv[u]);
        }
      }
    }
  }
  flush(cur, acc);
}

// Pass 2: one warp per output row, launched as a programmatic dependent of
// pass 1, so that it starts during pass 1's last wave.  An empty row is
// written as zeros at once; a row inside one chunk was written by pass 1;
// a row across chunks k0 .. k1 waits for pass 1, then adds its f32 pieces
// in chunk order (deterministic, no atomics): slot (p0 > k0 * chunk) of
// chunk k0, then slot 0 of each later chunk, U pieces in flight at a time
// (a hub row has tens of them).  VEC is pass 1's, so a lane owns the same
// columns in both passes.
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_rows_kernel(const int* __restrict__ ptr,
                     const float* __restrict__ scratch,
                     TO* __restrict__ out, int n_rows, int chunk, int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = LOADS / NV;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int c0 = blockIdx.y * 32 * VEC * NV + VEC * (threadIdx.x & 31);
  const int p0 = __ldg(ptr + r);
  const int p1 = __ldg(ptr + r + 1);
  Acc<NV, VEC> acc;
  zero<NV, VEC>(acc);
  if (p0 < p1) {
    const int k0 = p0 / chunk;
    const int k1 = (p1 - 1) / chunk;
    if (k0 == k1) return;
    // pass 1 has finished and its scratch is visible
    asm volatile("griddepcontrol.wait;" ::: "memory");
    load_acc<NV, VEC>(
        acc, scratch + static_cast<size_t>(2 * k0 + (p0 > k0 * chunk)) * d,
        d, c0, true);
    for (int k = k0 + 1; k <= k1; k += U) {
      Acc<NV, VEC> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_acc<NV, VEC>(v[u], scratch + static_cast<size_t>(2 * (k + u)) * d,
                          d, c0, k + u <= k1);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u <= k1) add_acc<NV, VEC>(acc, v[u]);
    }
  }
  store_row<TO, NV, VEC, true>(out + static_cast<size_t>(r) * d, acc, d, c0);
}

// loads per lane: a warp covers 32 * VEC columns of d up to that width,
// else twice as many
template <typename TI>
int vec_per_lane(int d) {
  return d <= 32 * Elem<TI>::VEC ? 1 : 2;
}

template <typename TI>
dim3 grid_for(long long items, int d, int nv) {
  const int cols = 32 * Elem<TI>::VEC * nv;
  return dim3(static_cast<unsigned>((items + WARPS - 1) / WARPS),
              static_cast<unsigned>((d + cols - 1) / cols));
}

template <typename TI, typename TO, int NV>
cudaError_t launch_rowwalk(const int* ptr, const int* col, const float* val,
                           const int* order, const TI* x, TO* out,
                           int n_rows, int d, cudaStream_t st) {
  rowwalk_kernel<TI, TO, NV>
      <<<grid_for<TI>(n_rows, d, NV), THREADS, 0, st>>>(
          ptr, col, val, order, x, out, n_rows, d);
  return cudaGetLastError();
}

template <typename TI, typename TO, int NV>
cudaError_t launch_blockpar(const int* ptr, const int* nz_row,
                            const int* col, const float* val, const TI* x,
                            float* scratch, TO* out, int n_rows, int nnz,
                            int chunk, int d, cudaStream_t st) {
  if (nnz > 0) {
    blockpar_chunk_kernel<TI, TO, NV>
        <<<grid_for<TI>((nnz + chunk - 1) / chunk, d, NV), THREADS, 0,
           st>>>(ptr, nz_row, col, val, x, scratch, out, nnz, chunk, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_for<TI>(n_rows, d, NV);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, blockpar_rows_kernel<TI, TO, NV>, ptr,
                            static_cast<const float*>(scratch), out, n_rows,
                            chunk, d);
}

template <typename TI, typename TO>
int rowwalk(const void* ptr, const void* col, const void* val,
            const void* order, const void* x, void* out, int n_rows, int d,
            void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int*>(ptr);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* od = static_cast<const int*>(order);
  const auto* xx = static_cast<const TI*>(x);
  auto* o = static_cast<TO*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_per_lane<TI>(d) == 1
          ? launch_rowwalk<TI, TO, 1>(p, c, v, od, xx, o, n_rows, d, st)
          : launch_rowwalk<TI, TO, 2>(p, c, v, od, xx, o, n_rows, d, st));
}

template <typename TI, typename TO>
int blockpar(const void* ptr, const void* nz_row, const void* col,
             const void* val, const void* x, void* scratch, void* out,
             int n_rows, int nnz, int chunk, int d, void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int*>(ptr);
  const auto* zr = static_cast<const int*>(nz_row);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* xx = static_cast<const TI*>(x);
  auto* s = static_cast<float*>(scratch);
  auto* o = static_cast<TO*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_per_lane<TI>(d) == 1
          ? launch_blockpar<TI, TO, 1>(p, zr, c, v, xx, s, o, n_rows, nnz,
                                       chunk, d, st)
          : launch_blockpar<TI, TO, 2>(p, zr, c, v, xx, s, o, n_rows, nnz,
                                       chunk, d, st));
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" int bsr_spmm_rowwalk(const void* ptr, const void* col,
                                const void* val, const void* order,
                                const void* x, void* out, int n_rows, int d,
                                void* stream) {
  return rowwalk<float, float>(ptr, col, val, order, x, out, n_rows, d,
                               stream);
}

extern "C" int bsr_spmm_blockpar(const void* ptr, const void* nz_row,
                                 const void* col, const void* val,
                                 const void* x, void* scratch, void* out,
                                 int n_rows, int nnz, int chunk, int d,
                                 void* stream) {
  return blockpar<float, float>(ptr, nz_row, col, val, x, scratch, out,
                                n_rows, nnz, chunk, d, stream);
}

// x in bf16; out in f32 when out_f32 is not 0, else in bf16
extern "C" int bsr_spmm_rowwalk_bf16(const void* ptr, const void* col,
                                     const void* val, const void* order,
                                     const void* x, void* out, int n_rows,
                                     int d, int out_f32, void* stream) {
  return out_f32 ? rowwalk<bf16, float>(ptr, col, val, order, x, out, n_rows,
                                        d, stream)
                 : rowwalk<bf16, bf16>(ptr, col, val, order, x, out, n_rows,
                                       d, stream);
}

extern "C" int bsr_spmm_blockpar_bf16(const void* ptr, const void* nz_row,
                                      const void* col, const void* val,
                                      const void* x, void* scratch, void* out,
                                      int n_rows, int nnz, int chunk, int d,
                                      int out_f32, void* stream) {
  return out_f32 ? blockpar<bf16, float>(ptr, nz_row, col, val, x, scratch,
                                         out, n_rows, nnz, chunk, d, stream)
                 : blockpar<bf16, bf16>(ptr, nz_row, col, val, x, scratch,
                                        out, n_rows, nnz, chunk, d, stream);
}

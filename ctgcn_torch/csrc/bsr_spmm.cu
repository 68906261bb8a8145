// Block-sparse (BSR, 128x128 blocks) SpMM  out = A @ x  for Hopper (sm_90a).
//
// Two kernels, one for each of the TPU kernels in
// ctgcn_tpu/ops/pallas_spmm.py.  Both compute in float32 with FFMA only (no
// TF32, no bf16), the counterpart of the TPU kernels' Precision.HIGHEST.
//
// What bounds them on the H100: the BSR blocks are dense 128x128 tiles, so
// every visited block costs 2*128*128*d FLOPs whatever its fill (0.38 % on
// the UCI k-core pyramid), against 64 KB of block bytes.  At d >= 64 that
// is ~2 * d / 4 = 32+ FLOP per byte, above the FP32 ridge of the card
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte): FP32 FFMA throughput bounds them.
// The product itself needs only its nonzeros, and its own bound (nnz values
// and indices, x and out, each once) is set by bytes and sits far below this
// dense-block work at such fill; kernels that skip the zeros are later work.
// The design keeps the FFMA pipe fed from shared memory and registers: each
// CUDA block stages one 32-wide k-slab of the A block (stored transposed)
// and of the matching x row tile in shared memory and accumulates a
// 128 x 64 output tile in registers, 8 x 4 per thread (12 shared loads per
// 32 FFMA).  Tensor cores (wgmma, 3xTF32) are later work.
//
// C interface for ctypes: every pointer and the stream is a void*, every
// call returns cudaGetLastError() so a refused launch is reported.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 128;   // BSR block edge (rows of an output tile)
constexpr int BN = 64;      // output columns per CUDA block (d tile)
constexpr int BK = 32;      // k-slab staged per shared-memory round
constexpr int THREADS = 256;
constexpr int TM = 8;       // output rows per thread
constexpr int TN = 4;       // output columns per thread

// 16-byte aligned: the compute loop reads both slabs as float4
struct __align__(16) Smem {
  float a[BK][TILE + 4];    // A slab, transposed: a[k][row]; +4 keeps float4
                            // alignment and spreads the transposed stores
  float x[BK][BN];          // x slab: x[k][col]
};

__device__ __forceinline__ void zero_acc(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// acc += blk @ x[xrow0 : xrow0 + 128, n0 : n0 + 64]
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ blk, const float* __restrict__ x, int xrow0,
    int d, int n0, Smem& s, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group: cols tx*4 .. tx*4+3
  const int ty = tid >> 4;   // row group:    rows ty*8 .. ty*8+7
  for (int k0 = 0; k0 < TILE; k0 += BK) {
    __syncthreads();  // the previous slab is consumed
#pragma unroll
    for (int it = 0; it < (TILE * BK / 4) / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int row = e >> 3;
      const int q = e & 7;
      const float4 v = *reinterpret_cast<const float4*>(
          blk + static_cast<size_t>(row) * TILE + k0 + q * 4);
      s.a[q * 4 + 0][row] = v.x;
      s.a[q * 4 + 1][row] = v.y;
      s.a[q * 4 + 2][row] = v.z;
      s.a[q * 4 + 3][row] = v.w;
    }
#pragma unroll
    for (int it = 0; it < (BK * BN / 4) / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e >> 4;
      const int c4 = e & 15;
      *reinterpret_cast<float4*>(&s.x[r][c4 * 4]) =
          *reinterpret_cast<const float4*>(
              x + static_cast<size_t>(xrow0 + k0 + r) * d + n0 + c4 * 4);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.x[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ out, int row0,
                                           int d, int n0,
                                           float (&acc)[TM][TN]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    *reinterpret_cast<float4*>(
        out + static_cast<size_t>(row0 + ty * TM + i) * d + n0 + tx * TN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Counterpart of _spmm_kernel: one CUDA block per (output row tile, d tile)
// walks row_ptr[r] .. row_ptr[r+1].  No cross-block reduction, so the
// result is deterministic; a row tile with many blocks serialises on one SM.
__global__ void __launch_bounds__(THREADS)
rowwalk_kernel(const float* __restrict__ blocks,
               const int* __restrict__ block_col,
               const int* __restrict__ row_ptr, const float* __restrict__ x,
               float* __restrict__ out, int d) {
  __shared__ Smem s;
  const int r = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero_acc(acc);
  const int b1 = row_ptr[r + 1];
  for (int b = row_ptr[r]; b < b1; ++b)
    accumulate_block(blocks + static_cast<size_t>(b) * TILE * TILE, x,
                     block_col[b] * TILE, d, n0, s, acc);
  store_tile(out, r * TILE, d, n0, acc);
}

// Counterpart of _spmm_v2_kernel, pass 1: one CUDA block per (chunk, d
// tile).  A chunk is at most a few consecutive blocks of one row run, so a
// row tile with many blocks spreads over many SMs.  Its partial product goes
// to scratch row tile c.
__global__ void __launch_bounds__(THREADS)
blockpar_partial_kernel(const float* __restrict__ blocks,
                        const int* __restrict__ block_col,
                        const int* __restrict__ chunk_ptr,
                        const float* __restrict__ x,
                        float* __restrict__ scratch, int d) {
  __shared__ Smem s;
  const int c = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero_acc(acc);
  const int b1 = chunk_ptr[c + 1];
  for (int b = chunk_ptr[c]; b < b1; ++b)
    accumulate_block(blocks + static_cast<size_t>(b) * TILE * TILE, x,
                     block_col[b] * TILE, d, n0, s, acc);
  store_tile(scratch, c * TILE, d, n0, acc);
}

// Pass 2: every output row tile sums its chunks' partials in chunk order
// (deterministic, no atomics); a row tile with no chunk is written as zeros.
__global__ void __launch_bounds__(THREADS)
blockpar_reduce_kernel(const float* __restrict__ scratch,
                       const int* __restrict__ row_chunk_ptr,
                       float* __restrict__ out, int d) {
  const int r = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[TM][TN];
  zero_acc(acc);
  const int c1 = row_chunk_ptr[r + 1];
  for (int c = row_chunk_ptr[r]; c < c1; ++c) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          scratch + static_cast<size_t>(c * TILE + ty * TM + i) * d + n0 +
          tx * TN);
      acc[i][0] += v.x;
      acc[i][1] += v.y;
      acc[i][2] += v.z;
      acc[i][3] += v.w;
    }
  }
  store_tile(out, r * TILE, d, n0, acc);
}

}  // namespace

extern "C" int bsr_spmm_rowwalk(const void* blocks, const void* block_col,
                                const void* row_ptr, const void* x, void* out,
                                int n_row_tiles, int d, void* stream) {
  if (n_row_tiles > 0) {
    const dim3 grid(n_row_tiles, d / BN);
    rowwalk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(block_col),
        static_cast<const int*>(row_ptr), static_cast<const float*>(x),
        static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsr_spmm_blockpar(const void* blocks, const void* block_col,
                                 const void* chunk_ptr,
                                 const void* row_chunk_ptr, const void* x,
                                 void* scratch, void* out, int n_chunks,
                                 int n_row_tiles, int d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, d / BN);
    blockpar_partial_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(block_col),
        static_cast<const int*>(chunk_ptr), static_cast<const float*>(x),
        static_cast<float*>(scratch), d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_row_tiles > 0) {
    const dim3 grid(n_row_tiles, d / BN);
    blockpar_reduce_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(scratch),
        static_cast<const int*>(row_chunk_ptr), static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}

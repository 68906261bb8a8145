// SpMM  out = A @ x  for Hopper (sm_90a) over the nonzeros of a CSR plan.
//
// Two kernels, one for each of the TPU kernels in
// ctgcn_tpu/ops/pallas_spmm.py:
//   rowwalk   replaces _spmm_kernel (:97): CTAs walk the plan's rows in its
//             walk order, in one launch;
//   blockpar  replaces _spmm_v2_kernel (:146): warps take equal chunks of
//             the nonzero stream in row order; a second pass adds the rows
//             that cross a chunk's edge.
// The TPU kernels multiply whole 128x128 blocks, which hold under 1 % of
// their entries here (0.38 % at UCI), so these kernels read and multiply
// only the plan's nonzeros, which the plan keeps in CSR beside a schedule
// that the host builds once per plan (ctgcn_torch/ops/bsr_spmm.py).
//
// Each kernel is a template on the element types of x and of out, with
// three instantiations: f32 -> f32, and for x in bf16 (the JAX package's
// ``ell_spmm(..., bf16=True)``, ctgcn_tpu/ops/ell.py:184-207) bf16 -> bf16
// for the forward and bf16 -> f32 for the backward.  A bf16 kernel rounds
// each value to bf16 as it loads it, multiplies and sums in f32, and rounds
// once, at the store, when out is bf16.
//
// What bounds them on the card.  Operations never: 2 * nnz * d FLOPs are a
// fraction of a microsecond at the FP32 peak, and the plans' dense tiles
// are under 1 % full, so tensor cores have nothing to do.  Bytes bound a
// large plan: one x row gathered from L2 per nonzero, and out written once
// (on the pyramid's forward plans most of out is empty rows).  Latency
// bounds a small one: a few thousand nonzeros give too few independent
// gathers to cover the L2 latency unless the work is spread over every SM
// and many gathers per warp are in flight.  The design:
//   * the schedule comes from the plan and d, never from a knob: the host
//     derives the chunk (16-128 nonzeros, about 16 warps a SM where nnz
//     allows it), lists the rows that cross a chunk's edge, the runs of
//     empty rows, the walk order's nonzeros and the walk's warp ranges,
//     and picks each kernel's way of gathering (the two flags below);
//   * x rows move by cp.async into a ring in shared memory, 16 bytes per
//     lane per copy, 16 cells a lane (64 KB a CTA of 8 warps): a batch of
//     steps a copy group, three batches in flight while one is added up,
//     without holding them in registers; a lane reads back only what it
//     copied itself, so the ring needs no barrier;
//   * a warp covers the full width (up to 512 columns) with NV 16-byte
//     pieces per lane, so a nonzero's (col, val, row) is read once; it
//     reads them 128 at a time as coalesced loads and broadcasts them with
//     __shfl_sync;
//   * at narrow d (d <= 64 f32, <= 128 bf16) the warp splits into G lane
//     groups of g = 32 / G lanes that take G consecutive nonzeros a step;
//     the groups' products are added per row by a segmented sum over
//     shuffles, in a fixed order;
//   * empty rows are written as zeros by more CTAs of the same launch, a
//     warp a run of at most 4 rows (up to 64 such CTAs a SM), 16-byte
//     streaming stores over the run's contiguous bytes split over the
//     grid-y slices: no warp per row and no ptr reads.  They follow the
//     walk's first wave (the CTAs resident at once, from the occupancy
//     API) and are spread evenly among its later CTAs, so their stores
//     drain while those gather;
//   * the row walk's CTAs take about 8 chunks of its walk stream, cut at
//     the walk order's group edges, so rows that share columns are
//     gathered on one SM; the CTA's 8 warps split its range evenly, so
//     short rows share a warp and a long row spreads over the CTA, and the
//     pieces of a row that crosses a warp's edge are added in shared
//     memory, in warp order, after the walk;
//   * a warp a row (``walk_rows``), where the walk groups' rows share
//     their columns (a node's nested core slots: UCI's pyramid) or the
//     plan's rows are short and too few to fill the card: the CTA's warps
//     walk rows of one group side by side, gathering into registers, so an
//     x row they share is read from L2 once and found in L1 by the others
//     (no ring: L1 keeps the SM's 256 KB) and a SM holds 64 warps;
//   * the block-parallel kernel's first pass gathers into registers in
//     chunks of 128 (``chunk_regs``) on plans that fill every SM with
//     chunks of 64, where the ring's shared memory, not the warps, caps
//     the loads in flight; its second pass runs only over the rows that
//     cross a chunk's edge and adds their f32 pieces (two scratch rows per
//     chunk) in chunk order; it is a programmatic dependent launch, so its
//     CTAs are resident when the first pass ends;
//   * FP32 FFMA in registers (no TF32), nonzeros in column order within a
//     row, partial sums added in a fixed order: the same input gives the
//     same bits, and there are no atomics anywhere;
//   * out is written once, with evict-first stores (__stcs), so the output
//     does not push x out of the 50 MB L2.
// Registers (94-109 a thread at NV = 4) hold a SM to two CTAs of the ring
// kernels; capping them at three CTAs spills and measured slower.
//
// C interface for ctypes: every pointer and the stream is a void*, every
// call returns the first CUDA error of its launches, so a refused launch is
// reported.  The kernels allocate nothing: the wrapper passes out and the
// block-parallel kernel's scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int WARPS = 8;                  // warps per CTA
constexpr int THREADS = WARPS * 32;
constexpr int RING = 16;                    // 16-byte ring cells per lane
constexpr int WARP_RING = RING * 32 * 16;   // bytes of a warp's ring
constexpr int RING_BYTES = WARPS * WARP_RING;  // bytes of a CTA's rings
constexpr int WINDOW = 128;               // nonzeros a warp indexes at once
constexpr int PER_LANE = WINDOW / 32;
constexpr int FILL_PER_SM = 64;          // most CTAs of the zero fill a SM
constexpr int PIECE_FLOATS = 64;          // pass 2: f32 loads in flight a lane
constexpr int LOADS = 8;                  // register gathers in flight a lane
constexpr unsigned FULL = 0xffffffffu;

// VEC: the values of T in one 16-byte piece; MAX_NV: most pieces per lane
// (a warp covers 32 * VEC * MAX_NV = 512 columns; wider d takes more CTAs
// along grid y)
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  static constexpr int MAX_NV = 4;
  __device__ static float round(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int MAX_NV = 2;
  // round to nearest even, as JAX's astype(bfloat16)
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Whether the block-parallel kernel's first pass may gather into registers
// (``chunk_regs``) for x of type T: f32 only.  A bf16 gather moves half
// the bytes, and its register pass spilled (40 bytes at NV = 2), so bf16
// plans keep the ring, at the chunk the plan gives.
template <typename T>
constexpr bool REGS_OF = sizeof(T) == 4;

// ---- PTX -------------------------------------------------------------------

// 16 bytes from global to shared, zero-filled past ``bytes`` (0 or 16)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_dependency() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---- a lane's columns and values -----------------------------------------

// A warp as G groups of g lanes (g a power of two); lane p of a group owns
// the columns cbase + (p + g * k) * VEC .. + VEC - 1, k < NV.
struct Lanes {
  int lane, g, G, q, p;
  __device__ explicit Lanes(int g_)
      : lane(static_cast<int>(threadIdx.x & 31)), g(g_), G(32 / g_),
        q(lane / g_), p(lane % g_) {}
};

template <int NV, int VEC>
using Vec = float[NV][VEC];

template <int NV, int VEC>
__device__ __forceinline__ void zero(Vec<NV, VEC>& a) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[k][j] = 0.f;
}

template <int NV, int VEC>
__device__ __forceinline__ void copy(Vec<NV, VEC>& a, const Vec<NV, VEC>& b) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[k][j] = b[k][j];
}

template <int NV, int VEC>
__device__ __forceinline__ void add(Vec<NV, VEC>& a, const Vec<NV, VEC>& b) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[k][j] += b[k][j];
}

// The VEC values of one 16-byte piece as floats
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

template <bool STREAM, typename V>
__device__ __forceinline__ void store16(V* p, V v) {
  if (STREAM)
    __stcs(p, v);
  else
    *p = v;
}

// A lane's values of one row, stored at its columns c0 + stride * k.
// STREAM: evict-first (the final output); else a plain store (scratch that
// pass 2 reads back from L2).  TO = float: VEC / 4 float4 stores; TO =
// bf16: VEC / 8 stores of 8 values, each rounded once.
template <typename TO, bool STREAM, int NV, int VEC>
__device__ __forceinline__ void store_vec(TO* __restrict__ dst,
                                          const Vec<NV, VEC>& v, int d,
                                          int c0, int stride) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + stride * k;
    if (c >= d) continue;
    if constexpr (sizeof(TO) == 4) {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        store16<STREAM>(reinterpret_cast<float4*>(dst + c) + i,
                        make_float4(v[k][4 * i], v[k][4 * i + 1],
                                    v[k][4 * i + 2], v[k][4 * i + 3]));
    } else {
      static_assert(VEC % 8 == 0, "bf16 out needs 8 values per lane");
#pragma unroll
      for (int i = 0; i < VEC / 8; ++i) {
        unsigned u[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(
              v[k][8 * i + 2 * h], v[k][8 * i + 2 * h + 1]);
          u[h] = *reinterpret_cast<const unsigned*>(&b);
        }
        store16<STREAM>(reinterpret_cast<uint4*>(dst + c) + i,
                        make_uint4(u[0], u[1], u[2], u[3]));
      }
    }
  }
}

// A lane's f32 values of a scratch row (pass 1's pieces, read from L2)
template <int NV, int VEC>
__device__ __forceinline__ void load_vec(Vec<NV, VEC>& v,
                                         const float* __restrict__ src,
                                         int d, int c0, int stride) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = c0 + stride * k;
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = c < d
          ? __ldcg(reinterpret_cast<const float4*>(src + c) + i)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[k][4 * i] = f.x;
      v[k][4 * i + 1] = f.y;
      v[k][4 * i + 2] = f.z;
      v[k][4 * i + 3] = f.w;
    }
  }
}

// A row walk's piece in the lane's own ring cells (slot 0 or 1): cell
// (slot * NV + k) * VEC / 4 + i of this lane, as a float4
template <int NV, int VEC>
__device__ __forceinline__ float4* piece_cell(unsigned char* ring, int lane,
                                              int slot, int k, int i) {
  const int cell = (slot * NV + k) * (VEC / 4) + i;
  return reinterpret_cast<float4*>(ring + (cell * 32 + lane) * 16);
}

template <int NV, int VEC>
__device__ __forceinline__ void put_piece(unsigned char* ring, int lane,
                                          int slot, const Vec<NV, VEC>& v) {
  static_assert(2 * NV * VEC / 4 <= RING,
                "pieces fit the lane's ring");
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      *piece_cell<NV, VEC>(ring, lane, slot, k, i) = make_float4(
          v[k][4 * i], v[k][4 * i + 1], v[k][4 * i + 2], v[k][4 * i + 3]);
}

template <int NV, int VEC>
__device__ __forceinline__ void get_piece(Vec<NV, VEC>& v,
                                          unsigned char* ring, int lane,
                                          int slot) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = *piece_cell<NV, VEC>(ring, lane, slot, k, i);
      v[k][4 * i] = f.x;
      v[k][4 * i + 1] = f.y;
      v[k][4 * i + 2] = f.z;
      v[k][4 * i + 3] = f.w;
    }
}

// one of the lane's PER_LANE window values (i uniform over the warp)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[PER_LANE], int i) {
  static_assert(PER_LANE == 4, "pick reads four registers");
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// ---- the walk ----------------------------------------------------------------

// A warp's range of the nonzero stream: its first and last rows, and
// whether they continue before / after it within [lo, hi).
struct Edge {
  int first_row, last_row;
  bool cross_start, cross_end;
};

// One warp walks stream positions [start, end) of [lo, hi): position t is
// nonzero walk_nz[t] when WALK (the row walk's order), else nonzero t.
// Rows are runs of the stream.  Each step, group q takes position base +
// s * G + q: its x row arrives through the ring, S - 1 steps after the copy
// was issued; the groups' products are summed per row (G > 1) and added to
// the carry of the row that the previous step left open.  A finished row
// goes to out, unless it is the first row and began before ``start``:
// then it is a piece (scratch slot 0 of chunk w, or, for the row walk,
// this lane's ring).  The last row is a piece when it continues past
// ``end`` or began before ``start``; a piece row's f32 values wait for the
// pass that adds them.
template <typename TI, typename TO, int NV, bool WALK>
__device__ __forceinline__ Edge walk(
    const int* __restrict__ nz_row, const int* __restrict__ col,
    const float* __restrict__ val, const int* __restrict__ walk_nz,
    const TI* __restrict__ x, TO* __restrict__ out,
    float* __restrict__ scratch, int w, int start, int end, int lo, int hi,
    int d, int cbase, const Lanes& ln, unsigned char* ring) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int S = RING / NV;  // steps the ring holds
  constexpr int U = NV >= 4 ? 1 : 4 / NV;  // steps a batch
  constexpr int B = S / U;            // batches the ring holds
  const int lane = ln.lane, g = ln.g, G = ln.G, q = ln.q;
  const int c0 = cbase + ln.p * VEC, stride = g * VEC;
  const auto nz = [&](int t) { return WALK ? __ldg(walk_nz + t) : t; };

  Edge e;
  e.first_row = __ldg(nz_row + nz(start));
  e.last_row = __ldg(nz_row + nz(end - 1));
  e.cross_start = start > lo && __ldg(nz_row + nz(start - 1)) == e.first_row;
  e.cross_end = end < hi && __ldg(nz_row + nz(end)) == e.last_row;

  const unsigned ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const auto cell = [&](int s, int k) { return ((s % S) * NV + k) * 32 + lane; };

  Vec<NV, VEC> acc, hold;
  zero<NV, VEC>(acc);
  zero<NV, VEC>(hold);
  int cur = -1;
  // a row that ends: out, or the first row's piece
  const auto finish = [&](int row, const Vec<NV, VEC>& v) {
    if (row == e.first_row && e.cross_start) {
      if constexpr (WALK)
        copy<NV, VEC>(hold, v);
      else if (q == 0)
        store_vec<float, false>(scratch + static_cast<size_t>(2 * w) * d, v,
                                d, c0, stride);
    } else if (q == 0) {
      store_vec<TO, true>(out + static_cast<size_t>(row) * d, v, d, c0,
                          stride);
    }
  };

  for (int base = start; base < end; base += WINDOW) {
    const int n = min(WINDOW, end - base);
    int wc[PER_LANE], wr[PER_LANE];
    float wv[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int t = lane + 32 * i;
      wc[i] = 0;
      wr[i] = -1;
      wv[i] = 0.f;
      if (t < n) {
        const int j = nz(base + t);
        wc[i] = __ldg(col + j);
        wv[i] = Elem<TI>::round(__ldg(val + j));
        wr[i] = __ldg(nz_row + j);
      }
    }
    const int steps = (n + G - 1) / G;
    // the groups past the window's end add zeros to its last row
    const int r_pad = __shfl_sync(FULL, pick(wr, (n - 1) >> 5), (n - 1) & 31);
    const auto issue = [&](int bt) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = bt * U + u;
        if (s < steps) {
          const int c = __shfl_sync(FULL, pick(wc, (s * G) >> 5),
                                    ((s * G) & 31) + q);
          const int bytes = s * G + q < n ? 16 : 0;
          const TI* xr = x + static_cast<size_t>(c) * d;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int cc = c0 + stride * k;
            if (cc < d) cp_async16(ring_s + cell(s, k) * 16, xr + cc, bytes);
          }
        }
      }
      cp_async_commit();
    };
    const auto step = [&](int s, const uint4 (&raw)[NV]) {
      const int i = (s * G) >> 5, src = ((s * G) & 31) + q;
      const float wt = __shfl_sync(FULL, pick(wv, i), src);
      int r = __shfl_sync(FULL, pick(wr, i), src);
      if (s * G + q >= n) r = r_pad;
      Vec<NV, VEC> xv;
#pragma unroll
      for (int k = 0; k < NV; ++k) unpack<TI>(xv[k], raw[k]);
      if (G == 1) {
        if (r != cur) {
          if (cur >= 0) finish(cur, acc);
          cur = r;
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[k][j] = wt * xv[k][j];
        } else {
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[k][j] = __fmaf_rn(wt, xv[k][j], acc[k][j]);
        }
      } else if constexpr (NV == 1) {
        // G groups on G consecutive nonzeros: per-row sums over the groups
        // (an inclusive segmented scan, offsets 1, 2, 4, ...), a fixed order
        float v[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = wt * xv[0][j];
        for (int o = 1; o < G; o <<= 1) {
          const int ro = __shfl_up_sync(FULL, r, o * g);
          float u[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) u[j] = __shfl_up_sync(FULL, v[j], o * g);
          if (q >= o && ro == r) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] += u[j];
          }
        }
        const int rn = __shfl_down_sync(FULL, r, g);
        const bool tail = q == G - 1 || rn != r;
        const int r_first = __shfl_sync(FULL, r, 0);
        const int r_last = __shfl_sync(FULL, r, 31);
        if (r_first != cur) {
          if (cur >= 0) finish(cur, acc);
        } else if (r == cur) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] += acc[0][j];
        }
        // the first row's piece when it ends inside this step
        if (r_first == e.first_row && r_last != r_first && e.cross_start) {
          const int t0 = __ffs(__ballot_sync(FULL, tail)) - 1;
          Vec<NV, VEC> h;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            h[0][j] = __shfl_sync(FULL, v[j], t0 + ln.p);
          finish(e.first_row, h);
        }
        // rows that begin and end inside this step's later segments
        if (tail && r != r_last && !(r == e.first_row && e.cross_start)) {
          Vec<NV, VEC> h;
#pragma unroll
          for (int j = 0; j < VEC; ++j) h[0][j] = v[j];
          store_vec<TO, true>(out + static_cast<size_t>(r) * d, h, d, c0,
                              stride);
        }
        // the last segment is the new carry, in every group
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[0][j] = __shfl_sync(FULL, v[j], 32 - g + ln.p);
        cur = r_last;
      }
    };
    // a batch is U steps, one copy group; the ring holds B batches, B - 1
    // of them in flight while one is added up
    const int batches = (steps + U - 1) / U;
#pragma unroll 1
    for (int bt = 0; bt < B - 1; ++bt) issue(bt);
#pragma unroll 1
    for (int bt = 0; bt < batches; ++bt) {
      issue(bt + B - 1);
      cp_async_wait<B - 1>();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = bt * U + u;
        if (s >= steps) continue;
        uint4 raw[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k)
          raw[k] = c0 + stride * k < d
              ? *reinterpret_cast<const uint4*>(ring + cell(s, k) * 16)
              : make_uint4(0u, 0u, 0u, 0u);
        step(s, raw);
      }
    }
  }
  cp_async_wait<0>();
  if (q != 0) return e;
  const bool last_piece = e.cross_end || (cur == e.first_row && e.cross_start);
  if (!last_piece)
    store_vec<TO, true>(out + static_cast<size_t>(cur) * d, acc, d, c0,
                        stride);
  if constexpr (WALK) {
    // the ring is drained: slot 0 the first row's piece, slot 1 the last's
    if (e.cross_start && e.first_row != e.last_row)
      put_piece<NV, VEC>(ring, lane, 0, hold);
    if (last_piece) put_piece<NV, VEC>(ring, lane, cur != e.first_row, acc);
  } else if (last_piece) {
    store_vec<float, false>(
        scratch + static_cast<size_t>(2 * w + (cur != e.first_row)) * d, acc,
        d, c0, stride);
  }
  return e;
}

// ---- the kernels -----------------------------------------------------------

// Zeros over run (first row, rows) of out by a warp's lanes, 16-byte
// streaming stores over its contiguous bytes
template <typename TO>
__device__ __forceinline__ void zero_run(int2 run, TO* __restrict__ out,
                                         int d, int lane) {
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(run.x) * d);
  const size_t n = static_cast<size_t>(run.y) * d * sizeof(TO) / 16;
  // the launch's grid-y slices split the run's bytes
  const size_t lo = n * blockIdx.y / gridDim.y;
  const size_t hi = n * (blockIdx.y + 1) / gridDim.y;
  for (size_t k = lo + lane; k < hi; k += 32)
    __stcs(dst + k, make_uint4(0u, 0u, 0u, 0u));
}

// Zeros for the empty rows, as runs (first row, rows) of a few rows (the
// host's FILL_RUN): a warp a run, its lanes over the run's contiguous
// 16-byte pieces with streaming stores, the warp's next run loaded while
// this one is stored.  This is fill CTA ``fb`` of ``nfb``.
template <typename TO>
__device__ __forceinline__ void fill_runs(const int2* __restrict__ runs,
                                          int n_runs, TO* __restrict__ out,
                                          int d, int fb, int nfb) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int stride = nfb * WARPS;
  int i = fb * WARPS + static_cast<int>(threadIdx.x >> 5);
  int2 run = i < n_runs ? __ldg(runs + i) : make_int2(0, 0);
  while (i < n_runs) {
    const int next_i = i + stride;
    const int2 next = next_i < n_runs ? __ldg(runs + next_i) : make_int2(0, 0);
    zero_run<TO>(run, out, d, lane);
    run = next;
    i = next_i;
  }
}

// The CTA's index among the n_walk CTAs that walk, in a launch whose other
// CTAs write the empty rows; -1 for those, after their share of the zeros.
// The first ``head`` CTAs walk (the walk's first wave: its latency chains
// start at once); the fill CTAs are spread evenly among the walking CTAs
// after them, so that their stores drain while later waves gather.
template <typename TO>
__device__ __forceinline__ int walk_cta(int n_walk, int head,
                                        const int2* __restrict__ runs,
                                        int n_runs, TO* __restrict__ out,
                                        int d) {
  const long long b = blockIdx.x;
  if (b < head) return static_cast<int>(b);
  const long long m = gridDim.x - head, n_fill = gridDim.x - n_walk;
  const long long r = b - head;
  // fill CTAs among the first r after the head
  const long long f0 = r * n_fill / m, f1 = (r + 1) * n_fill / m;
  if (f1 == f0) return static_cast<int>(head + r - f0);
  fill_runs<TO>(runs, n_runs, out, d, static_cast<int>(f0),
                static_cast<int>(n_fill));
  return -1;
}

// Counterpart of _spmm_kernel.  CTA b < n_cta walks the WARPS ranges of
// its walk stream that walk_warp[WARPS * b ..] bounds (about WARPS chunks
// of whole rows, split evenly); then each row that begins in a warp and
// continues into the next is added from the warps' pieces in warp order
// and stored.  The launch's other CTAs write the empty rows (walk_cta).
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS, 2)
rowwalk_kernel(const int* __restrict__ nz_row, const int* __restrict__ col,
               const float* __restrict__ val,
               const int* __restrict__ walk_nz,
               const int* __restrict__ walk_warp, int n_cta, int head,
               const int2* __restrict__ runs, int n_runs,
               const TI* __restrict__ x, TO* __restrict__ out, int d,
               int g) {
  constexpr int VEC = Elem<TI>::VEC;
  const int b = walk_cta<TO>(n_cta, head, runs, n_runs, out, d);
  if (b < 0) return;
  extern __shared__ uint4 smem[];
  __shared__ int s_flags[WARPS];
  const Lanes ln(g);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  unsigned char* rings = reinterpret_cast<unsigned char*>(smem);
  unsigned char* ring = rings + warp * WARP_RING;
  const int* bounds = walk_warp + static_cast<size_t>(b) * WARPS;
  const int lo = __ldg(bounds), hi = __ldg(bounds + WARPS);
  const int start = __ldg(bounds + warp), end = __ldg(bounds + warp + 1);
  const int cbase = static_cast<int>(blockIdx.y) * 32 * VEC * NV;
  Edge e{-1, -1, false, false};
  if (start < end)
    e = walk<TI, TO, NV, true>(nz_row, col, val, walk_nz, x, out, nullptr, 0,
                               start, end, lo, hi, d, cbase, ln, ring);
  // bit 0: the last row continues into the next warp; bit 1: one row
  // covers the whole warp
  if (ln.lane == 0)
    s_flags[warp] = (e.cross_end ? 1 : 0) |
                    (start < end && e.first_row == e.last_row ? 2 : 0);
  __syncthreads();
  if (e.cross_end && !(e.first_row == e.last_row && e.cross_start) &&
      ln.q == 0) {
    Vec<NV, VEC> acc, pc;
    get_piece<NV, VEC>(acc, ring, ln.lane, e.last_row != e.first_row);
    for (int j = warp + 1; j < WARPS; ++j) {
      get_piece<NV, VEC>(pc, rings + j * WARP_RING, ln.lane, 0);
      add<NV, VEC>(acc, pc);
      if ((s_flags[j] & 3) != 3) break;
    }
    store_vec<TO, true>(out + static_cast<size_t>(e.last_row) * d, acc, d,
                        cbase + ln.p * VEC, ln.g * VEC);
  }
}

// The row walk a warp a row (``walk_rows``), for plans whose walk groups
// share columns (a node's nested core slots name mostly the same x rows)
// or whose rows are short and too few to fill the card.  Warp w takes
// stream range [walk_warp[w], walk_warp[w + 1]), one whole
// row, and gathers its x rows into registers by read-only loads, LOADS in
// flight a lane.  The CTA's warps walk rows of one group side by side in
// column order, so an x row that they share is read from L2 once and found
// in L1 by the others: no ring, so L1 keeps the SM's 256 KB, and few
// registers, so a SM holds 64 warps.  A warp covers 32 * VEC * NV columns
// (NV <= 2), wider d more CTAs along grid y.  The launch's other CTAs
// write the empty rows (walk_cta).
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
rowwalk_rows_kernel(const int* __restrict__ nz_row,
                    const int* __restrict__ col,
                    const float* __restrict__ val,
                    const int* __restrict__ walk_nz,
                    const int* __restrict__ walk_warp, int n_cta,
                    int head, const int2* __restrict__ runs, int n_runs,
                    const TI* __restrict__ x, TO* __restrict__ out, int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = LOADS / NV;  // divides 32, so t + u < 32 below
  const int b = walk_cta<TO>(n_cta, head, runs, n_runs, out, d);
  if (b < 0) return;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int w = b * WARPS + static_cast<int>(threadIdx.x >> 5);
  const int start = __ldg(walk_warp + w), end = __ldg(walk_warp + w + 1);
  if (start >= end) return;
  // a row's nonzeros are consecutive in the CSR
  const int p0 = __ldg(walk_nz + start), p1 = p0 + (end - start);
  const int row = __ldg(nz_row + p0);
  const int c0 = static_cast<int>(blockIdx.y) * 32 * VEC * NV + VEC * lane;
  Vec<NV, VEC> acc;
  zero<NV, VEC>(acc);
  for (int base = p0; base < p1; base += 32) {
    const int n = min(32, p1 - base);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = Elem<TI>::round(__ldg(val + base + lane));
    }
    for (int t = 0; t < n; t += U) {
      uint4 xv[U][NV];
      float wt[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(FULL, my_col, t + u);
        wt[u] = __shfl_sync(FULL, my_val, t + u);
        const TI* xr = x + static_cast<size_t>(c) * d;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int cc = c0 + 32 * VEC * k;
          xv[u][k] = t + u < n && cc < d
              ? __ldg(reinterpret_cast<const uint4*>(xr + cc))
              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u >= n) continue;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float f[VEC];
          unpack<TI>(f, xv[u][k]);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[k][j] = __fmaf_rn(wt[u], f[j], acc[k][j]);
        }
      }
    }
  }
  store_vec<TO, true>(out + static_cast<size_t>(row) * d, acc, d, c0,
                      32 * VEC);
}

// Counterpart of _spmm_v2_kernel, pass 1.  Warp w takes nonzeros
// [w * chunk, (w + 1) * chunk) in row order.  A row inside the chunk goes
// straight to out; a row across the chunk's edge leaves its f32 piece in
// scratch row 2w + slot: slot 0 for the row that holds the chunk's first
// nonzero, slot 1 for the one that holds its last (when another row).
// The launch's other CTAs write the empty rows (walk_cta).
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS, 2)
blockpar_chunk_kernel(const int* __restrict__ nz_row,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const TI* __restrict__ x, float* __restrict__ scratch,
                      TO* __restrict__ out, const int2* __restrict__ runs,
                      int n_runs, int nnz, int chunk, int n_walk, int head,
                      int d, int g) {
  // pass 2 may start once every CTA of this pass has; it waits for this
  // pass to end before it reads anything
  launch_dependents();
  const int b = walk_cta<TO>(n_walk, head, runs, n_runs, out, d);
  if (b < 0) return;
  extern __shared__ uint4 smem[];
  const Lanes ln(g);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int w = b * WARPS + warp;
  const long long start = static_cast<long long>(w) * chunk;
  if (start < nnz)
    walk<TI, TO, NV, false>(
        nz_row, col, val, nullptr, x, out, scratch, w,
        static_cast<int>(start),
        static_cast<int>(start + chunk < nnz ? start + chunk : nnz), 0, nnz,
        d, static_cast<int>(blockIdx.y) * 32 * Elem<TI>::VEC * NV, ln,
        reinterpret_cast<unsigned char*>(smem) + warp * WARP_RING);
}

// A register pass's finished row: to out when it lies inside the chunk
// [start, end), else its f32 piece to scratch row 2w + (the row starts
// after the chunk's start)
template <typename TO, int NV, int VEC>
__device__ __forceinline__ void flush_row(const int* __restrict__ ptr,
                                          TO* __restrict__ out,
                                          float* __restrict__ scratch,
                                          int row, int start, int end, int w,
                                          const Vec<NV, VEC>& acc, int d,
                                          int c0) {
  const int p0 = __ldg(ptr + row), p1 = __ldg(ptr + row + 1);
  if (p0 >= start && p1 <= end)
    store_vec<TO, true>(out + static_cast<size_t>(row) * d, acc, d, c0,
                        32 * VEC);
  else
    store_vec<float, false>(
        scratch + static_cast<size_t>(2 * w + (p0 > start)) * d, acc, d, c0,
        32 * VEC);
}

// Pass 1 with register gathers, for plans large enough to fill the card
// with chunks of 128 nonzeros (``chunk_regs``): the ring's shared memory
// caps the loads in flight a SM, registers do not.  Warp w takes nonzeros
// [w * chunk, (w + 1) * chunk) in row order, 32 at a time, and gathers
// LOADS / NV x rows a lane into registers (read-only loads) before it adds
// them up; a warp covers 32 * VEC * NV columns (NV <= 2), wider d more CTAs
// along grid y.  Rows inside the chunk go to out; a row across its edge
// leaves its f32 piece in scratch as in blockpar_chunk_kernel.  The
// launch's other CTAs write the empty rows (walk_cta).
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_regs_kernel(const int* __restrict__ ptr,
                     const int* __restrict__ nz_row,
                     const int* __restrict__ col,
                     const float* __restrict__ val, const TI* __restrict__ x,
                     float* __restrict__ scratch, TO* __restrict__ out,
                     const int2* __restrict__ runs, int n_runs, int nnz,
                     int chunk, int n_walk, int head, int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = LOADS / NV;
  launch_dependents();
  const int b = walk_cta<TO>(n_walk, head, runs, n_runs, out, d);
  if (b < 0) return;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int w = b * WARPS + static_cast<int>(threadIdx.x >> 5);
  if (static_cast<long long>(w) * chunk >= nnz) return;
  const int start = w * chunk;
  const int end = min(nnz, start + chunk);
  const int c0 = static_cast<int>(blockIdx.y) * 32 * VEC * NV + VEC * lane;
  Vec<NV, VEC> acc;
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
      float wt[U];
      int rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(FULL, my_col, t + u);
        wt[u] = __shfl_sync(FULL, my_val, t + u);
        rows[u] = __shfl_sync(FULL, my_row, t + u);
        const TI* xr = x + static_cast<size_t>(c) * d;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int cc = c0 + 32 * VEC * k;
          xv[u][k] = t + u < n && cc < d
              ? __ldg(reinterpret_cast<const uint4*>(xr + cc))
              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u >= n) continue;
        if (rows[u] != cur) {
          flush_row<TO>(ptr, out, scratch, cur, start, end, w, acc, d, c0);
          zero<NV, VEC>(acc);
          cur = rows[u];
        }
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float f[VEC];
          unpack<TI>(f, xv[u][k]);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[k][j] = __fmaf_rn(wt[u], f[j], acc[k][j]);
        }
      }
    }
  }
  flush_row<TO>(ptr, out, scratch, cur, start, end, w, acc, d, c0);
}

// Pass 2, over the rows that cross a chunk's edge: cross[i] = (row, its
// first piece's scratch row, its last chunk k1).  Group q of a warp takes
// one such row and adds its pieces in chunk order: the first, then slot 0
// of each chunk up to k1, U pieces in flight at a time; then stores it.
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
blockpar_cross_kernel(const int* __restrict__ cross, int n_cross,
                      const float* __restrict__ scratch,
                      TO* __restrict__ out, int d, int g) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int U = PIECE_FLOATS / (NV * VEC);
  // pass 1 has finished and its scratch is visible
  wait_dependency();
  const Lanes ln(g);
  const long long i =
      (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) *
          ln.G + ln.q;
  if (i >= n_cross) return;
  const int row = __ldg(cross + 3 * i);
  const int first = __ldg(cross + 3 * i + 1);
  const int k1 = __ldg(cross + 3 * i + 2);
  const int c0 = static_cast<int>(blockIdx.y) * 32 * VEC * NV + ln.p * VEC;
  const int stride = ln.g * VEC;
  Vec<NV, VEC> acc;
  load_vec<NV, VEC>(acc, scratch + static_cast<size_t>(first) * d, d, c0,
                    stride);
  for (int k = first / 2 + 1; k <= k1; k += U) {
    Vec<NV, VEC> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u <= k1)
        load_vec<NV, VEC>(v[u], scratch + 2 * static_cast<size_t>(k + u) * d,
                          d, c0, stride);
      else
        zero<NV, VEC>(v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u <= k1) add<NV, VEC>(acc, v[u]);
  }
  store_vec<TO, true>(out + static_cast<size_t>(row) * d, acc, d, c0,
                      stride);
}

// ---- launches --------------------------------------------------------------

// Lanes per group, pieces per lane and grid-y slices for width d: the
// narrowest power-of-two group that covers d when a warp would cover more
// than twice d, else the whole warp over up to MAX_NV pieces a lane.
struct Geometry {
  int g, nv, slices;
};

template <typename TI>
Geometry geometry(int d) {
  constexpr int VEC = Elem<TI>::VEC;
  constexpr int MAX_NV = Elem<TI>::MAX_NV;
  if (d <= 16 * VEC) {
    int g = 1;
    while (g * VEC < d) g <<= 1;
    return {g, 1, 1};
  }
  const int per = (d + 32 * VEC - 1) / (32 * VEC);
  if (per <= MAX_NV) return {32, per <= 1 ? 1 : per <= 2 ? 2 : 4, 1};
  return {32, MAX_NV, (per + MAX_NV - 1) / MAX_NV};
}

// A warp a row: the whole warp over up to 2 pieces a lane, grid-y slices
// beyond that
template <typename TI>
Geometry row_geometry(int d) {
  const int per = (d + 32 * Elem<TI>::VEC - 1) / (32 * Elem<TI>::VEC);
  return {32, per <= 1 ? 1 : 2, per <= 2 ? 1 : (per + 1) / 2};
}

// Let ``Kernel`` take the ring, over the 48 KB default (once a kernel: a
// template on the kernel itself, since instantiations with one signature
// share a function type).  The split of the SM's memory between shared
// memory and L1 is left to the CUDA runtime, which measured no slower.
template <auto Kernel>
cudaError_t allow_ring() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  done = err == cudaSuccess;
  return err;
}

template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), dim3 grid, int smem,
                   cudaStream_t st, bool dependent, Act... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = dependent ? attr : nullptr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// SMs of the current card (read once: a process runs its kernels on one
// card)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = std::max(n, 1);
  }
  return n;
}

// CTAs of ``Kernel`` resident on the card at once, ``smem`` bytes each: the
// walk's first wave (once a kernel)
template <auto Kernel>
int wave(int smem) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, THREADS,
                                                  static_cast<size_t>(smem));
    per_sm = std::max(per_sm, 1);
  }
  return per_sm * sm_count();
}

// CTAs of the zero fill: a warp a run, at most FILL_PER_SM a SM
inline int fill_ctas(int n_runs) {
  return std::min(FILL_PER_SM * sm_count(), (n_runs + WARPS - 1) / WARPS);
}

template <typename TI, typename TO, int NV>
cudaError_t launch_rows(const int* nz_row, const int* col, const float* val,
                        const int* walk_nz, const int* walk_warp, int n_cta,
                        const int* runs, int n_runs, const TI* x, TO* out,
                        int d, int slices, cudaStream_t st) {
  constexpr auto kernel = rowwalk_rows_kernel<TI, TO, NV>;
  const int n_fill = fill_ctas(n_runs);
  if (n_cta + n_fill == 0) return cudaGetLastError();
  return launch(kernel, dim3(n_cta + n_fill, slices), 0, st, false, nz_row,
                col, val, walk_nz, walk_warp, n_cta,
                std::min(n_cta, wave<kernel>(0)),
                reinterpret_cast<const int2*>(runs), n_runs, x, out, d);
}

template <typename TI, typename TO, int NV>
cudaError_t launch_rowwalk(const int* nz_row, const int* col,
                           const float* val, const int* walk_nz,
                           const int* walk_warp, int n_cta, const int* runs,
                           int n_runs, const TI* x, TO* out, int d, int g,
                           int slices, cudaStream_t st) {
  constexpr auto kernel = rowwalk_kernel<TI, TO, NV>;
  const int n_fill = fill_ctas(n_runs);
  if (n_cta + n_fill == 0) return cudaGetLastError();
  if (n_cta > 0) {
    const cudaError_t err = allow_ring<kernel>();
    if (err != cudaSuccess) return err;
  }
  return launch(kernel, dim3(n_cta + n_fill, slices),
                n_cta > 0 ? RING_BYTES : 0, st, false, nz_row, col, val,
                walk_nz, walk_warp, n_cta,
                n_cta > 0 ? std::min(n_cta, wave<kernel>(RING_BYTES)) : 0,
                reinterpret_cast<const int2*>(runs), n_runs, x, out, d, g);
}

template <typename TI, typename TO, int NV>
cudaError_t launch_blockpar(const int* ptr, const int* nz_row,
                            const int* col, const float* val,
                            const int* cross, int n_cross, const int* runs,
                            int n_runs, const TI* x, float* scratch, TO* out,
                            int nnz, int chunk, int regs, int d, int g,
                            int slices, cudaStream_t st) {
  const int n_walk = ((nnz + chunk - 1) / chunk + WARPS - 1) / WARPS;
  const int n_fill = fill_ctas(n_runs);
  if (n_walk + n_fill > 0) {
    cudaError_t err = cudaSuccess;
    if constexpr (REGS_OF<TI>) {
      if (regs) {
        constexpr auto kernel = blockpar_regs_kernel<TI, TO, NV>;
        err = launch(kernel, dim3(n_walk + n_fill, slices), 0, st, false,
                     ptr, nz_row, col, val, x, scratch, out,
                     reinterpret_cast<const int2*>(runs), n_runs, nnz, chunk,
                     n_walk, std::min(n_walk, wave<kernel>(0)), d);
      }
    }
    if (!(REGS_OF<TI> && regs)) {
      constexpr auto kernel = blockpar_chunk_kernel<TI, TO, NV>;
      if (n_walk > 0) err = allow_ring<kernel>();
      if (err == cudaSuccess)
        err = launch(kernel, dim3(n_walk + n_fill, slices),
                     n_walk > 0 ? RING_BYTES : 0, st, false, nz_row, col, val,
                     x, scratch, out, reinterpret_cast<const int2*>(runs),
                     n_runs, nnz, chunk, n_walk,
                     n_walk > 0 ? std::min(n_walk, wave<kernel>(RING_BYTES))
                                : 0,
                     d, g);
    }
    if (err != cudaSuccess) return err;
  }
  if (n_cross == 0) return cudaGetLastError();
  const int per_cta = WARPS * (32 / g);
  return launch(blockpar_cross_kernel<TI, TO, NV>,
                dim3((n_cross + per_cta - 1) / per_cta, slices), 0, st, true,
                cross, n_cross, static_cast<const float*>(scratch), out, d,
                g);
}

template <typename TI, typename TO>
int rowwalk(const void* nz_row, const void* col, const void* val,
            const void* walk_nz, const void* walk_warp, int n_cta,
            int walk_rows, const void* runs, int n_runs, const void* x,
            void* out, int n_rows, int d, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* r = static_cast<const int*>(nz_row);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* wn = static_cast<const int*>(walk_nz);
  const auto* ww = static_cast<const int*>(walk_warp);
  const auto* ru = static_cast<const int*>(runs);
  const auto* xx = static_cast<const TI*>(x);
  auto* o = static_cast<TO*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (walk_rows) {
    const Geometry geo = row_geometry<TI>(d);
    const cudaError_t err =
        geo.nv == 1 ? launch_rows<TI, TO, 1>(r, c, v, wn, ww, n_cta, ru,
                                             n_runs, xx, o, d, geo.slices, st)
                    : launch_rows<TI, TO, 2>(r, c, v, wn, ww, n_cta, ru,
                                             n_runs, xx, o, d, geo.slices,
                                             st);
    return static_cast<int>(err);
  }
  const Geometry geo = geometry<TI>(d);
  constexpr int M = Elem<TI>::MAX_NV;
  const cudaError_t err =
      geo.nv == 1 ? launch_rowwalk<TI, TO, 1>(r, c, v, wn, ww, n_cta, ru,
                                              n_runs, xx, o, d, geo.g,
                                              geo.slices, st)
      : geo.nv == 2 ? launch_rowwalk<TI, TO, 2>(r, c, v, wn, ww, n_cta, ru,
                                                n_runs, xx, o, d, geo.g,
                                                geo.slices, st)
                    : launch_rowwalk<TI, TO, M>(r, c, v, wn, ww, n_cta, ru,
                                                n_runs, xx, o, d, geo.g,
                                                geo.slices, st);
  return static_cast<int>(err);
}

template <typename TI, typename TO>
int blockpar(const void* ptr, const void* nz_row, const void* col,
             const void* val, const void* cross, int n_cross,
             const void* runs, int n_runs, const void* x, void* scratch,
             void* out, int n_rows, int nnz, int chunk, int regs, int d,
             void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int*>(ptr);
  const auto* r = static_cast<const int*>(nz_row);
  const auto* c = static_cast<const int*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* cr = static_cast<const int*>(cross);
  const auto* ru = static_cast<const int*>(runs);
  const auto* xx = static_cast<const TI*>(x);
  auto* s = static_cast<float*>(scratch);
  auto* o = static_cast<TO*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry geo =
      REGS_OF<TI> && regs ? row_geometry<TI>(d) : geometry<TI>(d);
  constexpr int M = Elem<TI>::MAX_NV;
  const cudaError_t err =
      geo.nv == 1 ? launch_blockpar<TI, TO, 1>(p, r, c, v, cr, n_cross, ru,
                                               n_runs, xx, s, o, nnz, chunk,
                                               regs, d, geo.g, geo.slices, st)
      : geo.nv == 2 ? launch_blockpar<TI, TO, 2>(p, r, c, v, cr, n_cross, ru,
                                                 n_runs, xx, s, o, nnz,
                                                 chunk, regs, d, geo.g,
                                                 geo.slices, st)
                    : launch_blockpar<TI, TO, M>(p, r, c, v, cr, n_cross, ru,
                                                 n_runs, xx, s, o, nnz,
                                                 chunk, regs, d, geo.g,
                                                 geo.slices, st);
  return static_cast<int>(err);
}

using bf16 = __nv_bfloat16;

}  // namespace

// (csr_row, csr_col, val, walk_nz, walk_warp, n_cta, walk_rows,
//  empty_runs, n_runs, x, out, n_rows, d, stream)
extern "C" int bsr_spmm_rowwalk(const void* nz_row, const void* col,
                                const void* val, const void* walk_nz,
                                const void* walk_warp, int n_cta,
                                int walk_rows, const void* runs, int n_runs,
                                const void* x, void* out, int n_rows, int d,
                                void* stream) {
  return rowwalk<float, float>(nz_row, col, val, walk_nz, walk_warp, n_cta,
                               walk_rows, runs, n_runs, x, out, n_rows, d,
                               stream);
}

// (csr_ptr, csr_row, csr_col, val, cross_rows, n_cross, empty_runs, n_runs,
//  x, scratch, out, n_rows, nnz, chunk, regs, d, stream)
extern "C" int bsr_spmm_blockpar(const void* ptr, const void* nz_row,
                                 const void* col, const void* val,
                                 const void* cross, int n_cross,
                                 const void* runs, int n_runs, const void* x,
                                 void* scratch, void* out, int n_rows,
                                 int nnz, int chunk, int regs, int d,
                                 void* stream) {
  return blockpar<float, float>(ptr, nz_row, col, val, cross, n_cross, runs,
                                n_runs, x, scratch, out, n_rows, nnz, chunk,
                                regs, d, stream);
}

// x in bf16; out in f32 when out_f32 is not 0, else in bf16
extern "C" int bsr_spmm_rowwalk_bf16(const void* nz_row, const void* col,
                                     const void* val, const void* walk_nz,
                                     const void* walk_warp, int n_cta,
                                     int walk_rows, const void* runs,
                                     int n_runs, const void* x, void* out,
                                     int n_rows, int d, int out_f32,
                                     void* stream) {
  return out_f32 ? rowwalk<bf16, float>(nz_row, col, val, walk_nz, walk_warp,
                                        n_cta, walk_rows, runs, n_runs, x,
                                        out, n_rows, d, stream)
                 : rowwalk<bf16, bf16>(nz_row, col, val, walk_nz, walk_warp,
                                       n_cta, walk_rows, runs, n_runs, x, out,
                                       n_rows, d, stream);
}

extern "C" int bsr_spmm_blockpar_bf16(const void* ptr, const void* nz_row,
                                      const void* col, const void* val,
                                      const void* cross, int n_cross,
                                      const void* runs, int n_runs,
                                      const void* x, void* scratch, void* out,
                                      int n_rows, int nnz, int chunk,
                                      int regs, int d, int out_f32,
                                      void* stream) {
  return out_f32 ? blockpar<bf16, float>(ptr, nz_row, col, val, cross,
                                         n_cross, runs, n_runs, x, scratch,
                                         out, n_rows, nnz, chunk, regs, d,
                                         stream)
                 : blockpar<bf16, bf16>(ptr, nz_row, col, val, cross, n_cross,
                                        runs, n_runs, x, scratch, out, n_rows,
                                        nnz, chunk, regs, d, stream);
}

// The launch geometry at width d, for the wrappers to check their copy
// against: out = {g, NV, slices} of the ring kernels (by_row 0) or of the
// register kernels (by_row 1), then WARPS, RING_BYTES and LOADS.
extern "C" int bsr_spmm_geometry(int d, int bf16, int by_row, int* out) {
  const Geometry geo = bf16 ? (by_row ? row_geometry<__nv_bfloat16>(d)
                                      : geometry<__nv_bfloat16>(d))
                            : (by_row ? row_geometry<float>(d)
                                      : geometry<float>(d));
  const int v[6] = {geo.g, geo.nv, geo.slices, WARPS, RING_BYTES, LOADS};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

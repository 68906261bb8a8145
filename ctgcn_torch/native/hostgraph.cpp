// Host-side graph kernels of ctgcn_torch's preprocessing (C++, OpenMP);
// the same source as the JAX package's, so both packages write the same
// artifacts from the same seed.
//
//   hg_core_numbers    exact O(E) k-core peeling (Batagelj-Zaversnik bucket
//                      queue).
//   hg_simulate_walks  weighted random walks straight off CSR: per-hop
//                      binary-search inverse-CDF, one splitmix64 stream per
//                      walk (deterministic under OpenMP, whatever the thread
//                      count), no padded [N, max_deg] tables.
//
// Plain C ABI (no Python.h), built with g++ -O3 -fopenmp at first use and
// bound through ctypes (ctgcn_torch/native/__init__.py).
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// k-core decomposition, Batagelj–Zaveršnik "An O(m) Algorithm for Cores
// Decomposition of Networks" (2003).  Input: symmetric CSR with no
// self-loops (the contract of data/formats.get_sp_adj_mat); weights are
// connectivity-only, so only the structure arrays are needed.
// Output: core[v] per node (isolated nodes -> 0), matching both
// nx.core_number and the numpy peel (preprocessing/kcore.py).
// ---------------------------------------------------------------------------
void hg_core_numbers(int64_t n, const int64_t* indptr, const int32_t* indices,
                     int64_t* core) {
  if (n <= 0) return;
  std::vector<int64_t> deg(n);
  int64_t md = 0;
  for (int64_t v = 0; v < n; ++v) {
    deg[v] = indptr[v + 1] - indptr[v];
    if (deg[v] > md) md = deg[v];
  }
  // bucket sort vertices by degree
  std::vector<int64_t> bin(md + 2, 0), pos(n), vert(n);
  for (int64_t v = 0; v < n; ++v) bin[deg[v]]++;
  int64_t start = 0;
  for (int64_t d = 0; d <= md; ++d) {
    int64_t c = bin[d];
    bin[d] = start;
    start += c;
  }
  for (int64_t v = 0; v < n; ++v) {
    pos[v] = bin[deg[v]];
    vert[pos[v]] = v;
    bin[deg[v]]++;
  }
  for (int64_t d = md; d > 0; --d) bin[d] = bin[d - 1];
  bin[0] = 0;
  // peel in degree order
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = vert[i];
    core[v] = deg[v];
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      int64_t u = indices[e];
      if (deg[u] > deg[v]) {
        // swap u with the first vertex of its degree bucket, then shrink
        int64_t du = deg[u], pu = pos[u];
        int64_t pw = bin[du];
        int64_t w = vert[pw];
        if (u != w) {
          pos[u] = pw;
          vert[pu] = w;
          pos[w] = pu;
          vert[pw] = u;
        }
        bin[du]++;
        deg[u]--;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Random walks.  One walk per (start node, repeat) in the artifact layout
// walks[start * walk_time + rep, :] with walks[:, 0] = start.  cumw is the
// per-row *inclusive* running sum of edge weights aligned with `indices`
// (NULL -> uniform).  A walk reaching a degree-0 node stays in place (only
// possible for isolated starts on a symmetric graph); self-pairs are
// dropped downstream, so this equals ending the walk.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline double uniform01(uint64_t* s) {
  // 53-bit mantissa uniform in [0, 1)
  return (double)(splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
}

void hg_simulate_walks(int64_t n, const int64_t* indptr,
                       const int32_t* indices, const double* cumw,
                       int32_t walk_time, int32_t walk_length, uint64_t seed,
                       int32_t n_threads, int32_t* walks) {
  const int64_t n_walks = n * (int64_t)walk_time;
  const int64_t L = (int64_t)walk_length + 1;
#ifdef _OPENMP
  // n_threads > 0 caps the team per-call (the Python wrapper passes 1
  // inside multiprocessing workers, or OMP_NUM_THREADS); 0 = OpenMP
  // default.  num_threads clause, not
  // omp_set_num_threads — no process-global state.
  const int team = n_threads > 0 ? (int)n_threads : omp_get_max_threads();
#else
  const int team = 1;
  (void)team;
  (void)n_threads;
#endif
#pragma omp parallel for schedule(static) num_threads(team)
  for (int64_t w = 0; w < n_walks; ++w) {
    uint64_t st = seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(w + 1));
    (void)splitmix64(&st);  // decorrelate nearby walk ids
    int32_t cur = (int32_t)(w / walk_time);
    int32_t* row = walks + w * L;
    row[0] = cur;
    for (int64_t step = 1; step < L; ++step) {
      const int64_t s = indptr[cur], e = indptr[cur + 1];
      const int64_t d = e - s;
      if (d <= 0) {  // dead end: stay put
        row[step] = cur;
        continue;
      }
      double u = uniform01(&st);
      int64_t slot;
      if (cumw) {
        const double total = cumw[e - 1];
        const double target = u * total;
        // first slot with cumw >= target (branchless-ish binary search)
        int64_t lo = s, hi = e - 1;
        while (lo < hi) {
          int64_t mid = (lo + hi) >> 1;
          if (cumw[mid] < target)
            lo = mid + 1;
          else
            hi = mid;
        }
        slot = lo;
      } else {
        slot = s + (int64_t)(u * (double)d);
        if (slot >= e) slot = e - 1;
      }
      cur = indices[slot];
      row[step] = cur;
    }
  }
}

}  // extern "C"

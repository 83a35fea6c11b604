// Batched subsequence DTW (sDTW) on Hopper (sm_90a): one warp per query,
// R rows per lane, every operand of the recurrence in registers.
//
// Replaces the TPU kernel src/repro/kernels/sdtw/ops.py:140 sdtw_pallas
// (body src/repro/kernels/sdtw/sdtw.py::_sdtw_kernel), all variants:
// plain, span-tracking start lane, last-row capture. It computes exactly
// what sdtw.cu's wavefront kernel and the plain PyTorch version
// (../sdtw.py::sdtw_kernel_plain) compute, for queries of up to 32 * R
// rows (N <= 1536 at the largest R); longer queries stay on sdtw.cu.
// Plain C interface, built with nvcc and bound with ctypes by ../_build.py
// and ../ops.py.
//
// The recurrence, per query b (row i, reference column j):
//   S[0, j] = d(q[0], r[j])                                  (free start)
//   S[i, j] = sat_add(d(q[i], r[j]),
//                     min(S[i-1, j-1], S[i-1, j], S[i, j-1]))  (i >= 1)
// with S[i, -1] = bcol_in[i] (the chunk carry), columns < ref_lead or
// >= ref_len masked to BIG, all N rows computed, the carry exiting at
// column ref_len - 1, the strict-improvement harvest of row qlen - 1 (the
// earliest column wins), and in span mode a (value, start) pair per cell,
// ties to the smaller start. With the ban (the BAN instantiations, which
// the TPU kernel has no counterpart of), query b's global columns
// [excl_lo[b], excl_hi[b]) are masked like the slice's own masked columns:
// the self-join's trivial-match zone, which the reference computes by
// setting the banned distances to BIG (sat_add(BIG, x) = BIG).
//
// What bounds it on this card: int32 operations. nvcc emits a cell as 4
// instructions (a subtract, IABS or a multiply, VIMNMX3 for the three-way
// min, VIADDMNMX for the add and the saturating min) and 13 with the
// start lane (two lexicographic mins of three compares and two
// predicated moves each), against 4 bytes per query row and per
// reference sample read once: bytes are negligible.
//
// Design. The warp sweeps the DP matrix skewed: at step s, lane l
// evaluates column j = s - l for its rows [l*R, (l+1)*R), top to bottom.
//   * Left (S[i, j-1]) is the lane's own register from the previous step;
//     up and diagonal inside the lane are the registers of the row above.
//   * Up for the lane's first row is lane l-1's bottom value of the
//     previous step (__shfl_up_sync); its diagonal is the up value the
//     lane received one step earlier. Registers start at bcol_in, so
//     column -1 is just "the step before" and j == 0 needs no branch.
//   * The reference sample moves down the warp by shuffle as well; lane 0
//     takes r[s] from a 32-sample register batch, reloaded (coalesced,
//     one batch ahead) every 32 steps. No shared memory, no barrier.
// What the wavefront kernel paid per cell and this one pays per step or
// not at all: the tile-staging modulo, three ring-buffer pointers, the
// division to the first owned row, the mask, i == 0 and j == 0 branches,
// three shared loads and a store, the carry-exit and harvest tests and a
// block-wide barrier. Here the mask, the carry exit and the harvest lane
// are tested once per step on j, and row 0 (lane 0's slot 0) is a select
// on a loop-invariant predicate. (A select per cell for the mask instead
// of the branch keeps nvcc from fusing the saturating min into the add:
// three instructions a cell where VIADDMNMX is one.) The ban is one more
// test per step, shared by the lane's R rows: it depends on the column
// and the query only, and is moved into slice columns once per warp. The
// harvest reads a compile-time slot (R - 1) when row qlen - 1 is a lane's
// last row, the case of every fixed-length batch with R | N; other
// queries (ragged qlens, R not dividing N) take a second copy of the
// sweep that selects the slot with an unrolled select. Each warp picks
// its copy once, before the sweep.
//
// Integer arithmetic is done in unsigned 32-bit and cast back, so it
// wraps exactly like the reference's int32. The kernel allocates nothing
// and launches on the caller's stream; the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntBig = 1 << 29;
constexpr int kIntFar = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // queries per block; ops.py ROWS_MAX_WARPS

template <typename T>
struct Acc;

template <>
struct Acc<int> {
  static __device__ __forceinline__ int big() { return kIntBig; }
  static __device__ __forceinline__ int dist(int q, int r, bool square) {
    unsigned d = static_cast<unsigned>(q) - static_cast<unsigned>(r);
    if (square) return static_cast<int>(d * d);
    int di = static_cast<int>(d);
    return di < 0 ? static_cast<int>(0u - d) : di;
  }
  static __device__ __forceinline__ int sat_add(int a, int b) {
    int s = static_cast<int>(static_cast<unsigned>(a) +
                             static_cast<unsigned>(b));
    return s < kIntBig ? s : kIntBig;
  }
};

template <>
struct Acc<float> {
  static __device__ __forceinline__ float big() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float dist(float q, float r,
                                               bool square) {
    float d = q - r;
    return square ? d * d : fabsf(d);
  }
  static __device__ __forceinline__ float sat_add(float a, float b) {
    return a + b;
  }
};

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }

// Lexicographic min of (v1, s1) and (v2, s2): lower value, then lower start.
template <typename T>
__device__ __forceinline__ void lex_min(T& v1, int& s1, T v2, int s2) {
  if (v2 < v1 || (v2 == v1 && s2 < s1)) {
    v1 = v2;
    s1 = s2;
  }
}

struct Args {
  const void* q;          // (B, N) acc
  const void* r;          // (M,) acc
  const int* qlens;       // (B,)
  const void* bcol_in;    // (B, N) acc
  const int* bstart_in;   // (B, N)  span mode
  const void* best_in;    // (B,) acc
  const int* pos_in;      // (B,)
  const int* start_in;    // (B,)    span mode
  void* best_out;         // (B,) acc
  int* pos_out;           // (B,)
  int* start_out;         // (B,)    span mode
  void* bcol_out;         // (B, N) acc
  int* bstart_out;        // (B, N)  span mode
  void* lastrow;          // (B, M) acc, or null: no last-row capture
  int* lastrow_start;     // (B, M)  last-row capture, span mode
  const int* excl_lo;     // (B,)    BAN: banned global columns [lo, hi)
  const int* excl_hi;     // (B,)
  int B, N, M;
  int ref_offset, ref_len, ref_lead;
};

// The harvest state of one query: row qlen - 1 lives in lane `lane`,
// slot `slot`; `blank` when no row is last (qlen outside [1, N]).
template <typename T>
struct Harvest {
  int lane, slot;
  bool blank;
  T best;
  int pos, start;
};

// The sweep over all M columns. FIXED: the harvest row is slot R - 1.
// BAN: slice columns [ban_lo, ban_lo + ban_w) are masked.
template <typename T, bool TRACK, bool SQUARE, int R, bool FIXED, bool BAN>
__device__ __forceinline__ void sweep(const Args& a, int b, int lane,
                                      int lanes, const T (&qv)[R],
                                      T (&v)[R], int (&st)[R],
                                      Harvest<T>& h, int ban_lo,
                                      unsigned ban_w) {
  const int N = a.N, M = a.M;
  const T BIG = Acc<T>::big();
  const T* r = static_cast<const T*>(a.r);
  T* bcol_out = static_cast<T*>(a.bcol_out);
  T* lastrow = static_cast<T*>(a.lastrow);
  const size_t qoff = static_cast<size_t>(b) * N;
  const size_t loff = static_cast<size_t>(b) * M;
  const int row0 = lane * R;
  const bool first = lane == 0;

  T rb = lane < M ? r[lane] : T(0);              // r[s & ~31 + lane]
  T rn = 32 + lane < M ? r[32 + lane] : T(0);    // the batch after it
  T rcur = T(0);                                 // r[s - lane]
  T dg = BIG;                                    // S[row0 - 1, j - 1]
  int sdg = kIntFar;

  const int steps = M + lanes - 1;
  for (int s = 0; s < steps; ++s) {
    const T up_in = __shfl_up_sync(kFull, v[R - 1], 1);
    int sup_in = kIntFar;
    if (TRACK) sup_in = __shfl_up_sync(kFull, st[R - 1], 1);
    const T r_up = __shfl_up_sync(kFull, rcur, 1);
    const T r_new = __shfl_sync(kFull, rb, s & 31);
    rcur = first ? r_new : r_up;
    if ((s & 31) == 31) {
      rb = rn;
      const int jn = s + 33 + lane;
      rn = jn < M ? r[jn] : T(0);
    }
    T up = up_in, diag = dg;
    int sup = sup_in, sdiag = sdg;
    dg = up_in;
    sdg = sup_in;
    const int j = s - lane;
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(M)) continue;

    if (j >= a.ref_lead && j < a.ref_len &&
        !(BAN && static_cast<unsigned>(j - ban_lo) < ban_w)) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const T d = Acc<T>::dist(qv[k], rcur, SQUARE);
        T nv;
        int ns = kIntFar;
        if (TRACK) {                             // diag and left first:
          T mv = diag;                           // only the last min waits
          int ms = sdiag;                        // for the row above
          lex_min(mv, ms, v[k], st[k]);
          lex_min(mv, ms, up, sup);
          nv = Acc<T>::sat_add(d, mv);
          ns = ms;
        } else {
          nv = Acc<T>::sat_add(d, vmin(vmin(diag, up), v[k]));
        }
        if (k == 0 && first) {                   // row 0: free start
          nv = d;
          ns = a.ref_offset + j;
        }
        diag = v[k];
        v[k] = nv;
        up = nv;
        if (TRACK) {
          sdiag = st[k];
          st[k] = ns;
          sup = ns;
        }
      }
    } else {                                     // masked or banned
#pragma unroll
      for (int k = 0; k < R; ++k) {
        v[k] = BIG;
        if (TRACK) st[k] = kIntFar;
      }
    }

    if (j == a.ref_len - 1) {                    // the carry's exit column
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (row0 + k < N) {
          bcol_out[qoff + row0 + k] = v[k];
          if (TRACK) a.bstart_out[qoff + row0 + k] = st[k];
        }
      }
    }

    if (lane == h.lane) {
      T hv = v[R - 1];
      int hs = TRACK ? st[R - 1] : 0;
      if (!FIXED) {
        hv = v[0];
        if (TRACK) hs = st[0];
#pragma unroll
        for (int k = 1; k < R; ++k) {
          if (k == h.slot) {
            hv = v[k];
            if (TRACK) hs = st[k];
          }
        }
      }
      if ((FIXED || !h.blank) && hv < h.best) {  // strict: earlier wins
        h.best = hv;
        h.pos = a.ref_offset + j;
        if (TRACK) h.start = hs;
      }
      if (lastrow != nullptr) {
        lastrow[loff + j] = (!FIXED && h.blank) ? BIG : hv;
        if (TRACK)
          a.lastrow_start[loff + j] = (!FIXED && h.blank) ? kIntFar : hs;
      }
    }
  }
}

template <typename T, bool TRACK, bool SQUARE, int R, bool BAN>
__global__ void __launch_bounds__(kMaxWarps * 32)
sdtw_rows_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.B) return;                          // the whole warp
  const int N = a.N;
  const int lanes = (N + R - 1) / R;
  const int row0 = lane * R;
  const T BIG = Acc<T>::big();
  const T* q = static_cast<const T*>(a.q);
  const T* bcol_in = static_cast<const T*>(a.bcol_in);
  const size_t qoff = static_cast<size_t>(b) * N;

  T qv[R], v[R];
  int st[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k;
    const bool in = i < N;
    qv[k] = in ? q[qoff + i] : T(0);
    v[k] = in ? bcol_in[qoff + i] : BIG;
    st[k] = (TRACK && in) ? a.bstart_in[qoff + i] : kIntFar;
    if (in && a.ref_len <= 0) {                  // empty slice: pass through
      static_cast<T*>(a.bcol_out)[qoff + i] = v[k];
      if (TRACK) a.bstart_out[qoff + i] = st[k];
    }
  }

  int hrow = a.qlens[b] - 1;
  if (hrow >= N) hrow = -1;
  Harvest<T> h;
  h.blank = hrow < 0;
  h.lane = h.blank ? 0 : hrow / R;
  h.slot = h.blank ? 0 : hrow % R;
  h.best = static_cast<const T*>(a.best_in)[b];
  h.pos = a.pos_in[b];
  h.start = TRACK ? a.start_in[b] : -1;

  // The ban in slice columns, clipped to [0, M] (64-bit: the global range
  // may reach INT_FAR and the slice may start at a negative offset).
  int ban_lo = 0;
  unsigned ban_w = 0;
  if (BAN) {
    long long lo = static_cast<long long>(a.excl_lo[b]) - a.ref_offset;
    long long hi = static_cast<long long>(a.excl_hi[b]) - a.ref_offset;
    lo = lo < 0 ? 0 : (lo > a.M ? a.M : lo);
    hi = hi < lo ? lo : (hi > a.M ? a.M : hi);
    ban_lo = static_cast<int>(lo);
    ban_w = static_cast<unsigned>(hi - lo);
  }

  if (!h.blank && h.slot == R - 1)
    sweep<T, TRACK, SQUARE, R, true, BAN>(a, b, lane, lanes, qv, v, st, h,
                                          ban_lo, ban_w);
  else
    sweep<T, TRACK, SQUARE, R, false, BAN>(a, b, lane, lanes, qv, v, st, h,
                                           ban_lo, ban_w);

  // The lane owning the last row writes the harvest; with no last row,
  // lane 0 passes the carry's harvest through.
  if (lane == h.lane) {
    static_cast<T*>(a.best_out)[b] = h.best;
    a.pos_out[b] = h.pos;
    if (TRACK) a.start_out[b] = h.start;
  }
}

template <typename T, bool TRACK, bool SQUARE, bool BAN, int R>
int launch(const Args& a, int warps, cudaStream_t stream) {
  const int grid = (a.B + warps - 1) / warps;
  sdtw_rows_kernel<T, TRACK, SQUARE, R, BAN>
      <<<grid, warps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Rows per lane the library is built for: ops.py ROWS_PER_LANE.
template <typename T, bool TRACK, bool SQUARE, bool BAN>
int pick_rows(int rows, const Args& a, int warps, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<T, TRACK, SQUARE, BAN, 1>(a, warps, s);
    case 2: return launch<T, TRACK, SQUARE, BAN, 2>(a, warps, s);
    case 4: return launch<T, TRACK, SQUARE, BAN, 4>(a, warps, s);
    case 7: return launch<T, TRACK, SQUARE, BAN, 7>(a, warps, s);
    case 8: return launch<T, TRACK, SQUARE, BAN, 8>(a, warps, s);
    case 16: return launch<T, TRACK, SQUARE, BAN, 16>(a, warps, s);
    case 25: return launch<T, TRACK, SQUARE, BAN, 25>(a, warps, s);
    case 32: return launch<T, TRACK, SQUARE, BAN, 32>(a, warps, s);
    case 48: return launch<T, TRACK, SQUARE, BAN, 48>(a, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool BAN>
int pick_mode(int track, int square, int rows, const Args& a, int warps,
              cudaStream_t s) {
  if (track)
    return square ? pick_rows<T, true, true, BAN>(rows, a, warps, s)
                  : pick_rows<T, true, false, BAN>(rows, a, warps, s);
  return square ? pick_rows<T, false, true, BAN>(rows, a, warps, s)
                : pick_rows<T, false, false, BAN>(rows, a, warps, s);
}

template <typename T>
int pick_ban(int track, int square, int rows, const Args& a, int warps,
             cudaStream_t s) {
  return a.excl_lo != nullptr
             ? pick_mode<T, true>(track, square, rows, a, warps, s)
             : pick_mode<T, false>(track, square, rows, a, warps, s);
}

}  // namespace

extern "C" {

// Launches the rows kernel. is_float selects float32 (else int32)
// accumulation, square the square_diff metric (else abs_diff), track the
// start lane; a null lastrow_out disables the last-row capture; non-null
// excl_lo / excl_hi ((B,) int32, global columns) select the instantiation
// with the ban. rows is R (rows per lane, one of ops.py ROWS_PER_LANE, with
// 32 * rows >= N), warps the queries per block (1..8). Pointers of
// disabled outputs may be null. Returns the launch's cudaError_t (0 on
// success).
int sdtw_rows_launch(int is_float, int square, int track, const void* q,
                     const void* r, const void* qlens, const void* bcol_in,
                     const void* bstart_in, const void* best_in,
                     const void* pos_in, const void* start_in,
                     void* best_out, void* pos_out, void* start_out,
                     void* bcol_out, void* bstart_out, void* lastrow_out,
                     void* lastrow_start, const void* excl_lo,
                     const void* excl_hi, int B, int N, int M,
                     int ref_offset, int ref_len, int ref_lead, int rows,
                     int warps, void* stream) {
  if (B == 0) return 0;
  if (warps < 1 || warps > kMaxWarps || rows < 1 || 32 * rows < N ||
      (excl_lo == nullptr) != (excl_hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.r = r;
  a.qlens = static_cast<const int*>(qlens);
  a.bcol_in = bcol_in;
  a.bstart_in = static_cast<const int*>(bstart_in);
  a.best_in = best_in;
  a.pos_in = static_cast<const int*>(pos_in);
  a.start_in = static_cast<const int*>(start_in);
  a.best_out = best_out;
  a.pos_out = static_cast<int*>(pos_out);
  a.start_out = static_cast<int*>(start_out);
  a.bcol_out = bcol_out;
  a.bstart_out = static_cast<int*>(bstart_out);
  a.lastrow = lastrow_out;
  a.lastrow_start = static_cast<int*>(lastrow_start);
  a.excl_lo = static_cast<const int*>(excl_lo);
  a.excl_hi = static_cast<const int*>(excl_hi);
  a.B = B;
  a.N = N;
  a.M = M;
  a.ref_offset = ref_offset;
  a.ref_len = ref_len;
  a.ref_lead = ref_lead;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float ? pick_ban<float>(track, square, rows, a, warps, s)
                  : pick_ban<int>(track, square, rows, a, warps, s);
}

}  // extern "C"

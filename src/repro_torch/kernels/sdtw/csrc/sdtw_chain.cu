// Batched subsequence DTW (sDTW) on Hopper (sm_90a): one query split across
// the W warps of a block, each warp a register-tiled slab of rows, the
// warps chained through mbarrier-guarded rings in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/sdtw/ops.py:140 sdtw_pallas
// (body src/repro/kernels/sdtw/sdtw.py:129 _sdtw_kernel), all variants:
// plain (K1), span-tracking start lane (K2), last-row capture (K3). It is
// the redesign for this card of sdtw.cu's anti-diagonal wavefront and
// computes exactly what sdtw.cu, sdtw_rows.cu and the plain PyTorch version
// (../sdtw.py::sdtw_kernel_plain) compute, for queries of up to 32 * R * W
// rows (ops.py CHAIN_MAX_N); longer queries stay on sdtw.cu. Plain C
// interface, built with nvcc and bound with ctypes by ../_build.py and
// ../ops.py.
//
// The recurrence, per query b (row i, reference column j):
//   S[0, j] = d(q[0], r[j])                                  (free start)
//   S[i, j] = sat_add(d(q[i], r[j]),
//                     min(S[i-1, j-1], S[i-1, j], S[i, j-1]))  (i >= 1)
// with S[i, -1] = bcol_in[i] (the chunk carry), columns < ref_lead or
// >= ref_len masked to BIG, all N rows computed, the carry exiting at
// column ref_len - 1, the strict-improvement harvest of row qlen - 1 (the
// earliest column wins), and in span mode a (value, start) pair per cell,
// ties to the smaller start. With the ban (the BAN instantiations; the TPU
// kernel has none), query b's global columns [excl_lo[b], excl_hi[b]) are
// masked like the slice's own masked columns (the self-join's
// trivial-match zone, where the reference sets the distance to BIG).
//
// What bounds it on this card: int32 issue, as in sdtw_rows.cu. nvcc emits
// a cell as 4 instructions (13 with the start lane); bytes (4 per query row
// and per reference sample) are negligible.
//
// Design. Query b takes W <= 16 warps of one block; warp w owns rows
// [32 R w, 32 R (w + 1)) and lane l of it the R rows from 32 R w + R l, in
// registers. Inside a warp the sweep is sdtw_rows.cu's: at step t lane l
// evaluates column t - l; up and diagonal of the lane's first row come
// from lane l - 1 by __shfl_up_sync (the diagonal is the up value of the
// step before), registers start at bcol_in, and the mask, the ban, the
// carry exit and the harvest are tested once a step on the column. Each
// warp loads its own 32-sample reference batches, coalesced, one batch
// ahead; the repeats of the other warps hit L2. Between warps w and w + 1:
//   * lane 31 of warp w stores its bottom row's value (and start lane) at
//     each column into a ring of kSlots chunks of 32 columns in shared
//     memory, and arrives on the chunk's `full` mbarrier when the chunk is
//     written;
//   * warp w + 1 waits on `full` once every 32 steps, loads the chunk into
//     one register per lane and arrives on the chunk's `empty` mbarrier;
//     at step t lane 0 takes column t from lane t % 32 by __shfl_sync as
//     its up value and keeps the one of the step before as its diagonal;
//   * warp w waits on `empty` before it reuses a slot, so it runs up to
//     kSlots chunks ahead of warp w + 1.
// The sweep has no __syncthreads(): a warp waits and arrives once every 32
// steps, on its two neighbours only. A chained warp starts ~64 steps after
// the one above it (the skew of 32 lanes plus one chunk): 64 (W - 1) steps
// of fill against a launch's M + 31.
//
// What this removes from sdtw.cu, which paid per cell what is here paid
// per step or not at all: the block-wide barrier per anti-diagonal
// (N + M - 1 of them a launch), the ring arithmetic (three % 3 indices and
// a division to the first owned row), the mask, i == 0 and j == 0
// branches, three shared loads and a shared store, the carry-exit and
// harvest tests, and the serial walk of ~N / 512 rows a thread at large N.
// The handoff adds, per step and shared by the lane's R rows, one shuffle
// (two with the start lane) and lane 31's shared store, and per 32 steps
// one wait, one coalesced shared load and one arrive.
//
// The warp owning row qlen - 1 harvests and captures the last row (with no
// last row, warp 0's lane 0 passes the carry's harvest through); every
// warp writes the carry of its own rows at column ref_len - 1. Integer
// arithmetic is done in unsigned 32-bit and cast back, so it wraps exactly
// like the reference's int32. The kernel allocates nothing and launches on
// the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntBig = 1 << 29;
constexpr int kIntFar = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 4;             // ring depth in chunks; a power of two
constexpr int kRing = 32 * kSlots;    // columns a ring holds

// Most warps a block (so a query) takes: 512 threads, so that ptxas may
// give each 128 registers (the SM's 65,536 over the block; K2/K3 at
// R = 16 take 128) without spilling (ops.py CHAIN_MAX_WARPS).
constexpr int kMaxWarps = 16;

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

// Hopper's shared-memory barriers (PTX mbarrier): arrival counts, phases
// waited on by parity.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t"
      ".reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t"
      "}\n"
      :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
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

// The harvest state of one warp: row qlen - 1 lives in its lane `lane`,
// slot `slot` (lane -1: in another warp); `blank` when no row is last
// (qlen outside [1, N]).
template <typename T>
struct Harvest {
  int lane, slot;
  bool blank;
  T best;
  int pos, start;
};

// One warp's link to its neighbours: the ring it reads (in) and the ring
// it writes (out), each with its barriers, or null.
template <typename T>
struct Link {
  uint64_t *in_full, *in_empty, *out_full, *out_empty;
  const T* in_v;
  const int* in_s;
  T* out_v;
  int* out_s;
};

// Consumer side: wait for chunk c of the ring above, load it (lane l takes
// column 32 c + l) and release the slot.
template <typename T, bool TRACK>
__device__ __forceinline__ void take_chunk(const Link<T>& k, int c, int lane,
                                           T& in_v, int& in_s) {
  const int slot = c & (kSlots - 1);
  mbar_wait(k.in_full + slot, (c / kSlots) & 1);
  in_v = k.in_v[slot * 32 + lane];
  if (TRACK) in_s = k.in_s[slot * 32 + lane];
  mbar_arrive(k.in_empty + slot);
}

// The sweep of one warp over all M columns. FIXED: the harvest row is slot
// R - 1 (or in another warp). BAN: slice columns [ban_lo, ban_lo + ban_w)
// are masked. `top`: this lane holds row 0.
template <typename T, bool TRACK, bool SQUARE, int R, bool FIXED, bool BAN>
__device__ __forceinline__ void sweep(const Args& a, int b, int row0,
                                      int lane, int lanes, bool top,
                                      const Link<T>& k, const T (&qv)[R],
                                      T (&v)[R], int (&st)[R], T dg,
                                      int sdg, Harvest<T>& h, int ban_lo,
                                      unsigned ban_w) {
  const int N = a.N, M = a.M;
  const T BIG = Acc<T>::big();
  const T* r = static_cast<const T*>(a.r);
  T* bcol_out = static_cast<T*>(a.bcol_out);
  T* lastrow = static_cast<T*>(a.lastrow);
  const size_t qoff = static_cast<size_t>(b) * N;
  const size_t loff = static_cast<size_t>(b) * M;
  const bool first = lane == 0;
  const bool has_in = k.in_v != nullptr, has_out = k.out_v != nullptr;
  const bool writer = has_out && lane == 31;

  T rb = lane < M ? r[lane] : T(0);              // r[t & ~31 + lane]
  T rn = 32 + lane < M ? r[32 + lane] : T(0);    // the batch after it
  T rcur = T(0);                                 // r[t - lane]
  T in_v = BIG;                                  // column 32 c + lane of
  int in_s = kIntFar;                            // the row above the warp
  if (has_in) take_chunk<T, TRACK>(k, 0, lane, in_v, in_s);

  const int steps = M + lanes - 1;
  for (int t = 0; t < steps; ++t) {
    T up_in = __shfl_up_sync(kFull, v[R - 1], 1);
    int sup_in = kIntFar;
    if (TRACK) sup_in = __shfl_up_sync(kFull, st[R - 1], 1);
    const T ring_up = __shfl_sync(kFull, in_v, t & 31);
    int ring_sup = kIntFar;
    if (TRACK) ring_sup = __shfl_sync(kFull, in_s, t & 31);
    if (first) {                                 // the row above the warp
      up_in = ring_up;
      sup_in = ring_sup;
    }
    const T r_up = __shfl_up_sync(kFull, rcur, 1);
    const T r_new = __shfl_sync(kFull, rb, t & 31);
    rcur = first ? r_new : r_up;
    if ((t & 31) == 31) {                        // once every 32 steps
      rb = rn;
      const int jn = t + 33 + lane;
      rn = jn < M ? r[jn] : T(0);
      const int c = t >> 5;                      // lane 31's chunk now
      if (writer && c >= 1) mbar_arrive(k.out_full + ((c - 1) & (kSlots - 1)));
      if (has_in && (c + 1) * 32 < M) take_chunk<T, TRACK>(k, c + 1, lane,
                                                           in_v, in_s);
      if (has_out && c >= kSlots && c * 32 < M)
        mbar_wait(k.out_empty + (c & (kSlots - 1)), ((c / kSlots) & 1) ^ 1);
    }
    T up = up_in, diag = dg;
    int sup = sup_in, sdiag = sdg;
    dg = up_in;
    sdg = sup_in;
    const int j = t - lane;
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(M)) continue;

    if (j >= a.ref_lead && j < a.ref_len &&
        !(BAN && static_cast<unsigned>(j - ban_lo) < ban_w)) {
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        const T d = Acc<T>::dist(qv[kk], rcur, SQUARE);
        T nv;
        int ns = kIntFar;
        if (TRACK) {                             // diag and left first:
          T mv = diag;                           // only the last min waits
          int ms = sdiag;                        // for the row above
          lex_min(mv, ms, v[kk], st[kk]);
          lex_min(mv, ms, up, sup);
          nv = Acc<T>::sat_add(d, mv);
          ns = ms;
        } else {
          nv = Acc<T>::sat_add(d, vmin(vmin(diag, up), v[kk]));
        }
        if (kk == 0 && top) {                    // row 0: free start
          nv = d;
          ns = a.ref_offset + j;
        }
        diag = v[kk];
        v[kk] = nv;
        up = nv;
        if (TRACK) {
          sdiag = st[kk];
          st[kk] = ns;
          sup = ns;
        }
      }
    } else {                                     // masked or banned
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        v[kk] = BIG;
        if (TRACK) st[kk] = kIntFar;
      }
    }

    if (writer) {                                // the row below the warp
      k.out_v[j & (kRing - 1)] = v[R - 1];
      if (TRACK) k.out_s[j & (kRing - 1)] = st[R - 1];
    }

    if (j == a.ref_len - 1) {                    // the carry's exit column
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        if (row0 + kk < N) {
          bcol_out[qoff + row0 + kk] = v[kk];
          if (TRACK) a.bstart_out[qoff + row0 + kk] = st[kk];
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
        for (int kk = 1; kk < R; ++kk) {
          if (kk == h.slot) {
            hv = v[kk];
            if (TRACK) hs = st[kk];
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
  if (writer) mbar_arrive(k.out_full + (((M - 1) >> 5) & (kSlots - 1)));
}

// Dynamic shared memory of a block: per ring (a query's W - 1 links) the
// kSlots `full` and `empty` barriers, kRing values, kRing start lanes in
// span mode (ops.py chain_smem_bytes).
template <typename T, bool TRACK>
__host__ __device__ constexpr size_t ring_bytes() {
  return kSlots * 16 + kRing * (sizeof(T) + (TRACK ? 4 : 0));
}

template <typename T, bool TRACK, bool SQUARE, int R, bool BAN>
__global__ void __launch_bounds__(kMaxWarps * 32)
sdtw_chain_kernel(Args a, int warps) {
  extern __shared__ uint64_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp / warps;                    // query slot in the block
  const int w = warp - g * warps;
  const int qpb = blockDim.x / (32 * warps);
  const int b = blockIdx.x * qpb + g;
  const int rings = qpb * (warps - 1);

  uint64_t* full = smem;
  uint64_t* empty = smem + rings * kSlots;
  T* ring_v = reinterpret_cast<T*>(smem + 2 * rings * kSlots);
  int* ring_s = reinterpret_cast<int*>(ring_v + rings * kRing);
  for (int i = threadIdx.x; i < rings * kSlots; i += blockDim.x) {
    mbar_init(full + i, 1);                      // lane 31 of the writer
    mbar_init(empty + i, 32);                    // every lane of the reader
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();                               // the only block barrier
  if (b >= a.B) return;                          // the query's every warp

  Link<T> k = {};
  if (w > 0) {
    const int ri = g * (warps - 1) + w - 1;
    k.in_full = full + ri * kSlots;
    k.in_empty = empty + ri * kSlots;
    k.in_v = ring_v + ri * kRing;
    k.in_s = ring_s + ri * kRing;
  }
  if (w < warps - 1) {
    const int ro = g * (warps - 1) + w;
    k.out_full = full + ro * kSlots;
    k.out_empty = empty + ro * kSlots;
    k.out_v = ring_v + ro * kRing;
    k.out_s = ring_s + ro * kRing;
  }

  const int N = a.N;
  const int wrow0 = w * 32 * R;
  const int row0 = wrow0 + lane * R;
  int lanes = (N - wrow0 + R - 1) / R;           // lanes holding rows < N
  if (lanes > 32) lanes = 32;
  const T BIG = Acc<T>::big();
  const T* q = static_cast<const T*>(a.q);
  const T* bcol_in = static_cast<const T*>(a.bcol_in);
  const size_t qoff = static_cast<size_t>(b) * N;

  T qv[R], v[R];
  int st[R];
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    const int i = row0 + kk;
    const bool in = i < N;
    qv[kk] = in ? q[qoff + i] : T(0);
    v[kk] = in ? bcol_in[qoff + i] : BIG;
    st[kk] = (TRACK && in) ? a.bstart_in[qoff + i] : kIntFar;
    if (in && a.ref_len <= 0) {                  // empty slice: pass through
      static_cast<T*>(a.bcol_out)[qoff + i] = v[kk];
      if (TRACK) a.bstart_out[qoff + i] = st[kk];
    }
  }
  // Lane 0's diagonal at column 0: the carry of the row above the warp.
  T dg = BIG;
  int sdg = kIntFar;
  if (w > 0 && lane == 0) {
    dg = bcol_in[qoff + wrow0 - 1];
    if (TRACK) sdg = a.bstart_in[qoff + wrow0 - 1];
  }

  int hrow = a.qlens[b] - 1;
  if (hrow >= N) hrow = -1;
  Harvest<T> h;
  h.blank = hrow < 0;
  const int hwarp = h.blank ? 0 : hrow / (32 * R);
  h.lane = w != hwarp ? -1 : h.blank ? 0 : (hrow - wrow0) / R;
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

  const bool top = w == 0 && lane == 0;
  if (h.lane < 0 || (!h.blank && h.slot == R - 1))
    sweep<T, TRACK, SQUARE, R, true, BAN>(a, b, row0, lane, lanes, top, k,
                                          qv, v, st, dg, sdg, h, ban_lo,
                                          ban_w);
  else
    sweep<T, TRACK, SQUARE, R, false, BAN>(a, b, row0, lane, lanes, top, k,
                                           qv, v, st, dg, sdg, h, ban_lo,
                                           ban_w);

  // The lane owning the last row writes the harvest; with no last row,
  // warp 0's lane 0 passes the carry's harvest through.
  if (lane == h.lane) {
    static_cast<T*>(a.best_out)[b] = h.best;
    a.pos_out[b] = h.pos;
    if (TRACK) a.start_out[b] = h.start;
  }
}

template <typename T, bool TRACK, bool SQUARE, bool BAN, int R>
int launch(const Args& a, int warps, int qpb, cudaStream_t stream) {
  if (warps * qpb > kMaxWarps || 32 * R * warps < a.N ||
      (warps > 1 && 32 * R * (warps - 1) >= a.N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.B + qpb - 1) / qpb;
  const size_t smem = static_cast<size_t>(qpb) * (warps - 1) *
                      ring_bytes<T, TRACK>();
  sdtw_chain_kernel<T, TRACK, SQUARE, R, BAN>
      <<<grid, qpb * warps * 32, smem, stream>>>(a, warps);
  return static_cast<int>(cudaGetLastError());
}

// Rows per lane the library is built for: ops.py CHAIN_ROWS.
template <typename T, bool TRACK, bool SQUARE, bool BAN>
int pick_rows(int rows, const Args& a, int warps, int qpb, cudaStream_t s) {
  switch (rows) {
    case 4: return launch<T, TRACK, SQUARE, BAN, 4>(a, warps, qpb, s);
    case 8: return launch<T, TRACK, SQUARE, BAN, 8>(a, warps, qpb, s);
    case 16: return launch<T, TRACK, SQUARE, BAN, 16>(a, warps, qpb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool BAN>
int pick_mode(int track, int square, int rows, const Args& a, int warps,
              int qpb, cudaStream_t s) {
  if (track)
    return square ? pick_rows<T, true, true, BAN>(rows, a, warps, qpb, s)
                  : pick_rows<T, true, false, BAN>(rows, a, warps, qpb, s);
  return square ? pick_rows<T, false, true, BAN>(rows, a, warps, qpb, s)
                : pick_rows<T, false, false, BAN>(rows, a, warps, qpb, s);
}

template <typename T>
int pick_ban(int track, int square, int rows, const Args& a, int warps,
             int qpb, cudaStream_t s) {
  return a.excl_lo != nullptr
             ? pick_mode<T, true>(track, square, rows, a, warps, qpb, s)
             : pick_mode<T, false>(track, square, rows, a, warps, qpb, s);
}

}  // namespace

extern "C" {

// Launches the chain kernel. is_float selects float32 (else int32)
// accumulation, square the square_diff metric (else abs_diff), track the
// start lane; a null lastrow_out disables the last-row capture; non-null
// excl_lo / excl_hi ((B,) int32, global columns) select the instantiation
// with the ban. rows is R (rows per lane, one of ops.py CHAIN_ROWS), warps
// the W warps of a query (32 * R * W >= N > 32 * R * (W - 1)), qpb the
// queries per block (qpb * W <= 16). Pointers of disabled
// outputs may be null. Returns the launch's cudaError_t (0 on success).
int sdtw_chain_launch(int is_float, int square, int track, const void* q,
                      const void* r, const void* qlens, const void* bcol_in,
                      const void* bstart_in, const void* best_in,
                      const void* pos_in, const void* start_in,
                      void* best_out, void* pos_out, void* start_out,
                      void* bcol_out, void* bstart_out, void* lastrow_out,
                      void* lastrow_start, const void* excl_lo,
                      const void* excl_hi, int B, int N, int M,
                      int ref_offset, int ref_len, int ref_lead, int rows,
                      int warps, int qpb, void* stream) {
  if (B == 0) return 0;
  if (warps < 1 || qpb < 1 || M < 1 ||
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
  return is_float ? pick_ban<float>(track, square, rows, a, warps, qpb, s)
                  : pick_ban<int>(track, square, rows, a, warps, qpb, s);
}

}  // extern "C"

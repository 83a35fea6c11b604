// Batched subsequence DTW (sDTW) on Hopper (sm_90a): the anti-diagonal
// wavefront.
//
// Replaces the TPU kernel src/repro/kernels/sdtw/sdtw.py::_sdtw_kernel,
// launched by src/repro/kernels/sdtw/ops.py::sdtw_pallas (all variants:
// plain, span-tracking start lane, last-row capture). Plain C interface,
// built with nvcc and bound with ctypes by ../_build.py and ../ops.py.
//
// What it computes, per query b (row i, reference column j):
//   S[0, j] = d(q[0], r[j])                                  (free start)
//   S[i, j] = sat_add(d(q[i], r[j]),
//                     min(S[i-1, j-1], S[i-1, j], S[i, j-1]))  (i >= 1)
// with S[i, -1] = bcol_in[i] (the chunk carry), columns < ref_lead or
// >= ref_len masked to BIG, all N rows computed (the carry covers padded
// rows), the carry exiting at column ref_len - 1, and the best / leftmost
// end / start of row qlen-1 harvested with a strict improvement test, so
// an earlier slice or column wins a tie. In span mode every cell carries
// its start lane as a lexicographic (value, start) pair, ties to the
// smaller start. With the ban (the BAN instantiations; the TPU kernel has
// none), query b's global columns [excl_lo[b], excl_hi[b]) are masked like
// the slice's masked columns: the self-join's trivial-match zone, where
// the reference sets the distance to BIG (sat_add(BIG, x) = BIG).
//
// What differs from the TPU. The TPU kernel walks a sequential grid axis
// over reference tiles and carries the boundary column in VMEM scratch
// between grid steps. CUDA blocks run in no order, so here one block owns
// block_q queries for the WHOLE reference: a loop over the N + M - 1
// anti-diagonals replaces the tile grid, and the chunk carry is simply the
// block's state at entry (bcol_in) and exit (bcol_out). The TPU solved
// each row with a (min,+) prefix scan across lanes; the wavefront applies
// the recurrence directly, cell by cell (MATSA §III-E's schedule). For
// int32 this is bitwise the scan's answer, since saturating min-plus is
// exactly associative below INT_BIG; float32 differs in summation order.
//
// Layout. Thread t of a query owns rows t, t + tpq, t + 2 tpq, ... The
// last two diagonals and the one being written live in shared memory (a
// ring of three, indexed by row), with one __syncthreads() per diagonal.
// The query sits in shared memory; reference samples are staged through a
// shared ring of `ring` >= N + tile samples, `tile` at a time, loaded
// during the last diagonal of the previous tile so the per-diagonal
// barrier orders them. When a block's query rows and diagonals do not fit
// in shared memory (long queries), they live in a global scratch the
// wrapper allocates, one region per block, and the reference is read from
// device memory directly (ring = 0); __syncthreads() orders those global
// accesses within the block just the same.
//
// What bounds it on this card: int32 ALU operations. Each cell costs a
// subtract, an abs (or a multiply), two mins, an add and a saturating min
// (about 6 operations; the span lane adds two lexicographic mins, about
// 14 in all), against 4 bytes per query row and per reference sample
// read from device memory once: bytes are negligible. The design keeps
// every operand in registers or shared memory and pays one barrier per
// diagonal, shared by the block's block_q queries.
//
// Integer arithmetic is done in unsigned 32-bit and cast back, so it
// wraps exactly like the reference's int32 (signed overflow is undefined
// in C++). The kernel allocates nothing and launches on the caller's
// stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntBig = 1 << 29;
constexpr int kIntFar = 0x7fffffff;

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
  void* lastrow;          // (B, M) acc   last-row capture
  int* lastrow_start;     // (B, M)       last-row capture, span mode
  const int* excl_lo;     // (B,)   BAN: banned global columns [lo, hi)
  const int* excl_hi;     // (B,)
  int B, N, M;
  int ref_offset, ref_len, ref_lead;
  int block_q, tpq, tile, ring;   // ring == 0: no staging (global scratch)
  void* scratch;                 // global scratch, or null: shared memory
  size_t block_bytes;            // scratch bytes of one block
};

// SCRATCH: the block's layout lives in the global scratch (a separate
// instantiation, so the shared-memory one keeps its shared loads). BAN:
// each query masks its banned columns.
template <typename T, bool TRACK, bool LASTROW, bool SQUARE, bool SCRATCH,
          bool BAN>
__global__ void sdtw_wavefront_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, M = a.M;
  const int slot = threadIdx.x / a.tpq;
  const int t = threadIdx.x % a.tpq;
  const int b = blockIdx.x * a.block_q + slot;
  const bool active = b < a.B;
  const T BIG = Acc<T>::big();

  // Block layout (shared memory, or this block's region of the global
  // scratch): reference ring, then per query slot: the query row and
  // three diagonals of values (and of start lanes in span mode).
  constexpr bool staged = !SCRATCH;
  T* base = staged ? reinterpret_cast<T*>(smem)
                   : reinterpret_cast<T*>(static_cast<unsigned char*>(
                         a.scratch) + blockIdx.x * a.block_bytes);
  const T* rs = staged ? base : static_cast<const T*>(a.r);
  T* rring = base;                                  // staged mode only
  T* qs = base + a.ring + static_cast<size_t>(slot) * 4 * N;
  T* dv = qs + N;                                   // dv[c * N + i]
  int* ds = reinterpret_cast<int*>(base + a.ring +
                                   static_cast<size_t>(a.block_q) * 4 * N) +
            static_cast<size_t>(slot) * 3 * N;     // span mode only
  const int mask = staged ? a.ring - 1 : -1;

  const T* q = static_cast<const T*>(a.q);
  const T* r = static_cast<const T*>(a.r);
  const T* bcol_in = static_cast<const T*>(a.bcol_in);
  T* bcol_out = static_cast<T*>(a.bcol_out);
  T* lastrow = static_cast<T*>(a.lastrow);
  const size_t qoff = static_cast<size_t>(b) * N;
  const size_t loff = static_cast<size_t>(b) * M;

  int hrow = -1;
  T best = BIG;
  int pos = -1, start = -1;
  // The ban in slice columns [ban_lo, ban_lo + ban_w), clipped to [0, M]
  // (64-bit: the global range may reach INT_FAR, the slice start below 0).
  int ban_lo = 0;
  unsigned ban_w = 0;
  if (active) {
    if (BAN) {
      long long lo = static_cast<long long>(a.excl_lo[b]) - a.ref_offset;
      long long hi = static_cast<long long>(a.excl_hi[b]) - a.ref_offset;
      lo = lo < 0 ? 0 : (lo > M ? M : lo);
      hi = hi < lo ? lo : (hi > M ? M : hi);
      ban_lo = static_cast<int>(lo);
      ban_w = static_cast<unsigned>(hi - lo);
    }
    hrow = a.qlens[b] - 1;
    if (hrow >= N) hrow = -1;
    best = static_cast<const T*>(a.best_in)[b];
    pos = a.pos_in[b];
    if (TRACK) start = a.start_in[b];
    for (int i = t; i < N; i += a.tpq) {
      qs[i] = q[qoff + i];
      if (a.ref_len <= 0) {                      // empty slice: pass through
        bcol_out[qoff + i] = bcol_in[qoff + i];
        if (TRACK) a.bstart_out[qoff + i] = a.bstart_in[qoff + i];
      }
    }
  }
  // Row capture when no row is the last one (qlen outside [1, N]).
  const int lr_row = hrow >= 0 ? hrow : 0;
  const bool lr_blank = hrow < 0;

  for (int j = threadIdx.x; staged && j < a.tile && j < M; j += blockDim.x)
    rring[j & mask] = r[j];
  __syncthreads();

  const int K = N + M - 1;
  for (int k = 0; k < K; ++k) {
    if (staged && (k + 1) % a.tile == 0) {         // stage the next tile
      for (int j = k + 1 + threadIdx.x; j < k + 1 + a.tile && j < M;
           j += blockDim.x)
        rring[j & mask] = r[j];
    }
    if (active) {
      T* cur = dv + (k % 3) * N;
      const T* p1 = dv + ((k + 2) % 3) * N;        // diagonal k - 1
      const T* p2 = dv + ((k + 1) % 3) * N;        // diagonal k - 2
      int* curs = ds + (k % 3) * N;
      const int* ps1 = ds + ((k + 2) % 3) * N;
      const int* ps2 = ds + ((k + 1) % 3) * N;
      const int i_lo = k - M + 1 > 0 ? k - M + 1 : 0;
      // First owned row >= i_lo, then every tpq-th.
      int i = t + ((i_lo > t) ? (i_lo - t + a.tpq - 1) / a.tpq * a.tpq : 0);
      const int i_hi = k < N - 1 ? k : N - 1;
      for (; i <= i_hi; i += a.tpq) {
        const int j = k - i;
        T val;
        int st = kIntFar;
        if (j < a.ref_lead || j >= a.ref_len ||
            (BAN && static_cast<unsigned>(j - ban_lo) < ban_w)) {
          val = BIG;
        } else {
          const T d = Acc<T>::dist(qs[i], rs[j & mask], SQUARE);
          if (i == 0) {
            val = d;
            st = a.ref_offset + j;
          } else {
            T up = p1[i - 1], left, diag;
            int sup = 0, sleft = 0, sdiag = 0;
            if (j == 0) {
              left = bcol_in[qoff + i];
              diag = bcol_in[qoff + i - 1];
              if (TRACK) {
                sleft = a.bstart_in[qoff + i];
                sdiag = a.bstart_in[qoff + i - 1];
              }
            } else {
              left = p1[i];
              diag = p2[i - 1];
              if (TRACK) {
                sleft = ps1[i];
                sdiag = ps2[i - 1];
              }
            }
            if (TRACK) {
              sup = ps1[i - 1];
              T mv = diag;
              int ms = sdiag;
              lex_min(mv, ms, up, sup);
              lex_min(mv, ms, left, sleft);
              val = Acc<T>::sat_add(d, mv);
              st = ms;
            } else {
              val = Acc<T>::sat_add(d, vmin(vmin(diag, up), left));
            }
          }
        }
        cur[i] = val;
        if (TRACK) curs[i] = st;
        if (j == a.ref_len - 1) {                  // the carry's exit column
          bcol_out[qoff + i] = val;
          if (TRACK) a.bstart_out[qoff + i] = st;
        }
        if (i == lr_row) {
          if (!lr_blank && val < best) {           // strict: earlier wins
            best = val;
            pos = a.ref_offset + j;
            if (TRACK) start = st;
          }
          if (LASTROW) {
            lastrow[loff + j] = lr_blank ? BIG : val;
            if (TRACK) a.lastrow_start[loff + j] = lr_blank ? kIntFar : st;
          }
        }
      }
    }
    __syncthreads();
  }

  // The thread owning the last row writes the harvest; with no last row,
  // thread 0 of the slot passes the carry's harvest through.
  if (active && ((hrow >= 0 && t == hrow % a.tpq) || (hrow < 0 && t == 0))) {
    static_cast<T*>(a.best_out)[b] = best;
    a.pos_out[b] = pos;
    if (TRACK) a.start_out[b] = start;
  }
}

template <typename T, bool TRACK, bool LASTROW, bool SQUARE, bool BAN>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = sdtw_wavefront_kernel<T, TRACK, LASTROW, SQUARE, false, BAN>;
  if (a.scratch != nullptr) {
    kernel = sdtw_wavefront_kernel<T, TRACK, LASTROW, SQUARE, true, BAN>;
    smem = 0;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (a.B + a.block_q - 1) / a.block_q;
  kernel<<<grid, a.block_q * a.tpq, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TRACK, bool LASTROW, bool SQUARE>
int pick_ban(const Args& a, size_t smem, cudaStream_t s) {
  return a.excl_lo != nullptr
             ? launch<T, TRACK, LASTROW, SQUARE, true>(a, smem, s)
             : launch<T, TRACK, LASTROW, SQUARE, false>(a, smem, s);
}

template <typename T, bool TRACK, bool LASTROW>
int pick_metric(int square, const Args& a, size_t smem, cudaStream_t s) {
  return square ? pick_ban<T, TRACK, LASTROW, true>(a, smem, s)
                : pick_ban<T, TRACK, LASTROW, false>(a, smem, s);
}

template <typename T>
int pick_mode(int track, int lastrow, int square, const Args& a, size_t smem,
              cudaStream_t s) {
  if (track)
    return lastrow ? pick_metric<T, true, true>(square, a, smem, s)
                   : pick_metric<T, true, false>(square, a, smem, s);
  return lastrow ? pick_metric<T, false, true>(square, a, smem, s)
                 : pick_metric<T, false, false>(square, a, smem, s);
}

// Bytes of one block's layout: the reference ring, and per query the
// query row and three diagonals (plus their start lanes in span mode).
// ops.py::smem_bytes is the same formula; the wrapper sizes the global
// scratch with it (ring = 0) when it exceeds the shared-memory limit.
size_t smem_bytes(int n, int block_q, int ring, int track) {
  return 4 * (static_cast<size_t>(ring) +
              static_cast<size_t>(block_q) * n * (track ? 7 : 4));
}

}  // namespace

extern "C" {

// Launches the wavefront kernel. is_float selects float32 (else int32)
// accumulation, square the square_diff metric (else abs_diff), track the
// start lane, lastrow the last-row capture; non-null excl_lo / excl_hi
// ((B,) int32, global columns) select the instantiation with the ban.
// scratch, when not null, holds smem_bytes(N, block_q, 0, track) bytes for
// each block of the grid, and ring is then ignored. Pointers of disabled
// outputs may be null. Returns the launch's cudaError_t (0 on success).
int sdtw_launch(int is_float, int square, int track, int lastrow,
                const void* q, const void* r, const void* qlens,
                const void* bcol_in, const void* bstart_in,
                const void* best_in, const void* pos_in,
                const void* start_in, void* best_out, void* pos_out,
                void* start_out, void* bcol_out, void* bstart_out,
                void* lastrow_out, void* lastrow_start, const void* excl_lo,
                const void* excl_hi, int B, int N, int M, int ref_offset,
                int ref_len, int ref_lead, int block_q, int tpq, int tile,
                int ring, void* scratch, void* stream) {
  if (B == 0) return 0;
  if ((excl_lo == nullptr) != (excl_hi == nullptr))
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
  a.block_q = block_q;
  a.tpq = tpq;
  a.tile = tile;
  a.scratch = scratch;
  a.ring = scratch != nullptr ? 0 : ring;
  a.block_bytes = smem_bytes(N, block_q, 0, track);
  const size_t smem = smem_bytes(N, block_q, a.ring, track);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float ? pick_mode<float>(track, lastrow, square, a, smem, s)
                  : pick_mode<int>(track, lastrow, square, a, smem, s);
}

}  // extern "C"

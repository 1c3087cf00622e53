// Segment kernels of the GNN message passing, for Hopper (sm_90a).
//
// K1  segment_sum_sorted: out[b, n, :] = sum of msgs[b, e, :] over the real
//     edges e (mask[b, e] != 0) whose destination dst[b, e] == n. The edges of
//     each graph are sorted by dst (padding edges carry dst = N-1 and are
//     masked), so the edges of one destination row are one contiguous range.
//     Replaces the Pallas kernel caster_dta_tpu/ops/pallas_segment.py
//     ::_segment_kernel_t (one-hot MXU matmuls per destination-row block).
//     On this card the sum is bound by memory bytes: it does one add per
//     message element read. Each row is summed in f32 in edge order, as the
//     plain version (index_add_ on the CPU) sums it, so every output equals
//     the plain version's bit for bit; a row is never split into partial sums
//     (scripts/k3_split_sum_error.py). The padding row N-1 holds every padding
//     edge of its graph (~700 at the flagship bucket, ~30,000 at the large
//     protein); a kernel that walks it edge by edge in one thread, as this
//     port's first K1 did, is set by it. Design (segment_walk_kernel, shared
//     with K8): one block of 16 warps per (graph, tile of rows); a warp takes
//     up to WALK_GROUP consecutive rows and finds their edge range with one
//     16-ary search of both ends on the sorted dst (a short range is counted
//     whole in one round). Where the range holds at most WALK_SHORT edges
//     the warp sums it (walk_group): lanes own features, the message rows go
//     out WALK_WINDOW at a time beside the range's dst and mask, and bit masks
//     of the real edges and of each row's last edge drive one running sum. A
//     longer row goes to the whole block: its mask is scanned WALK_SPAN edges
//     a pass and its real edges compacted in order into shared memory (a pass
//     with none costs one barrier and no message load, so the masked padding
//     row costs ~E_pad / WALK_SPAN barriers), then 15 warps keep a ring of
//     tiles of the listed message rows in flight (cp.async for f32) while
//     warp 0 adds them in order. A graph of at most SMALL_FLOATS message
//     values (the molecules) takes one block instead (segment_small_kernel):
//     it stages the graph's messages, dst and mask with one round of loads and
//     sums every row from shared memory. Rows of at most K1_NARROW_F columns
//     (the zoo's in-degrees and segment_softmax's denominators) take the
//     narrow kernel (segment_narrow_kernel, k1_route): there a warp-per-row
//     walk leaves a lane in 32 at work and its searches and the padding
//     row's pass are fixed costs that no byte pays for, so a block per
//     (graph, slice of rows) keeps the slice's real edges in edge order (a
//     ballot per 32 edges, one scan) and a thread adds each row. Deterministic,
//     no atomics; a row with no real edge comes out 0.
//
// K2  gather_rows: out[b, e, :] = table[b, idx[b, e], :] for any index order.
//     Replaces the Pallas kernel caster_dta_tpu/ops/pallas_segment.py
//     ::_onehot_gather_kernel (one-hot MXU matmul against the node table).
//     Bound by memory bytes: a pure copy. Three kernels, by the row's bytes:
//     - a row of 16-byte vectors, or of one vector of 2, 4 or 8 bytes
//       (gather_rows_kernel): each thread copies one vector, the widest that
//       divides the row's bytes and the table's alignment, so neighbouring
//       threads read neighbouring addresses of a row;
//     - any other row (21, 51 or 59 f32 columns, odd bf16 widths, a table off
//       16-byte alignment). One vector a thread would be 4 or 2 bytes there,
//       each with two 64-bit divisions and a reload of its row's index, bound
//       by instructions. Both kernels for these rows store 16-byte vectors of
//       the output, whatever F is, and find each element's row and column by
//       fixed steps, not by division:
//       - where a graph's table fits K2_STAGE_BYTES (the molecule graphs),
//         a block per 128 edges of a graph stages the whole table in shared
//         memory with wide loads beside its edges' indices, then writes
//         their output rows (gather_staged_kernel): one round trip to device
//         memory before the stores;
//       - otherwise (gather_runs_kernel) the output [B * E, F] is one
//         contiguous run of elements, and a warp copies R consecutive output
//         rows at a time (R of 8, 16 or 32 by the gather's size:
//         k2_run_rows). Lane l < R reads the index of the run's row l once
//         (its source row b * N + idx; (graph, edge) split once a run); the
//         warp's lanes take the run's 16-byte output vectors in turn (a run
//         of 8 rows starts 16-byte aligned whatever F is). A vector's
//         elements come from one or more source rows, each row's by shuffle
//         from the lane that read it, in loads as wide as the row's bytes and
//         the table's alignment allow. A lane's (row, column) in the run is
//         the same in every run and moves by a fixed step a round. A partial
//         last run ends with element stores.
//     Either way an exact copy, bit for bit.
//
// K3  scatter_rows: out[b, n, :] = sum of rows[b, e, :] over every edge e
//     (no mask) whose id[b, e] == n; the ids are in any order. The transpose
//     of K2, so the backward of every row gather. Replaces the Pallas kernels
//     caster_dta_tpu/ops/pallas_segment.py::_scatter_fullN_kernel and
//     ::_segment_kernel_dense (one-hot MXU matmuls against the edge chunks,
//     bf16 in one exact pass, f32 in a 3-pass mantissa split). Here the sum
//     is bound by memory bytes, as K1's is. Each row is summed in f32 in edge
//     order, as the plain version (index_add_ on the CPU) sums it, so every
//     output equals the plain version's bit for bit. A row is not split into
//     partial sums: padding puts ~30,000-40,000 ids on rows 0 and N-1 of the
//     large-protein bucket, and partials of 128 ids added in order land up to
//     15x the 1e-5 tolerance away from the edge-order sum
//     (scripts/k3_split_sum_error.py). Deterministic, no atomics on values;
//     an empty row comes out 0. Rows of at most K3_NARROW_F columns (the
//     cotangents of segment_softmax's gathers, H = 1 or 2) take one launch of
//     the narrow kernel (scatter_narrow_kernel, k3_route): a block per
//     (graph, slice of rows) counts its ids a row and warp, places each
//     kept edge's values in row order, and a thread adds each row, the
//     padding row's values 16 bytes a load ahead of its chain of adds; an
//     edge whose values are all +-0 is left out (it cannot move an in-order
//     sum from +0). Wider rows: a graph whose rows (as f32), ids and CSR fit
//     one block's shared memory (the molecule graphs) takes one launch,
//     scatter_small_kernel: its block stages them, builds the CSR as below
//     with one block, and a warp per (row, 32 features) adds the row's staged
//     values. A larger graph takes two launches:
//     1. scatter_csr_kernel: a stable CSR by id per graph, row_ptr[B, N+1] and
//        perm[B, E] (each graph's edges in (id, e) order), and the list of
//        its rows of more than K3_LONG ids. A cluster of up to 8 blocks per
//        graph; each warp (a walker) owns a contiguous segment of the ids and
//        a row of N counts in its block's shared memory. The walkers count
//        their ids (ranks within 32 ids from __match_any_sync), the blocks
//        total their columns and read each other's totals over distributed
//        shared memory, every block scans the columns, and each walker places
//        its edges in edge order. Integer counts only, no atomics. Where N
//        counts do not fit the shared memory, one block per graph keeps them
//        in a global table (workspace). An id outside [0, N) traps here.
//     2. scatter_sum_kernel: a warp per row of at most K3_LONG ids (lanes own
//        features, 16 rows in flight), and up to K3_LONG_SLOTS blocks per
//        graph for the longer rows: 31 warps gather K3_TILE rows of a long
//        row at a time, widened to f32, into double-buffered shared memory,
//        and one warp adds them in order. A long row is bound by those loads
//        and by its add chain (one dependent f32 add per id).
//
// K7  gather_windowed: K2's function, out[b, e, :] = table[b, idx[b, e], :],
//     an exact copy. Replaces the Pallas kernel caster_dta_tpu/ops/
//     pallas_segment.py::_gather_window_kernel (per chunk of edges, one-hot MXU
//     products against only the 128-row node windows that the chunk's indices
//     span, from a scalar-prefetched window start and count). Bound by memory
//     bytes, as K2 is. Design: one block per (graph, chunk of K7_EDGES
//     edges). The block loads its chunk's indices, finds their span itself
//     (min and max, no prefetch), then walks the span in windows of as many
//     table rows as K7_WINDOW_BYTES of shared memory hold: each window's rows
//     are one contiguous, coalesced read into shared memory, and every edge
//     whose index falls in the window copies its row out of shared memory
//     (16, 8, 4 or 2 bytes a thread, as K2's gather_rows_kernel). Sorted indices (dst) span a few
//     rows a chunk and read each table row about once; unsorted ones span the
//     table and read it whole per chunk. Not dispatched on any path, as in the
//     JAX package, which measured it and kept the resident-table gather.
//
// K8  segment_sum_2d: out[b, n, :] = sum of msgs[b, e, :] over every edge e
//     (no mask: the messages are already masked) whose dst[b, e] == n; dst
//     sorted within each graph; f32 only. The row-major form of K1. Replaces
//     the Pallas kernel caster_dta_tpu/ops/pallas_segment.py::_segment_kernel
//     (one-hot MXU products over the edge chunks of a block of node rows, its
//     edge range from a block-pointer table). Bound by memory bytes. K1's
//     walker with the mask switched off at compile time: every edge counts,
//     so the zeroed padding row is a long row of real values, staged whole
//     through the ring and added in edge order by one warp; it is bound by
//     one SM's loads and its add chain (one dependent f32 add an edge). The
//     sums equal K1's bit for bit on the same masked rows (a zeroed row adds
//     +0 to a sum that starts at +0).
//
// Plain C interface, loaded with ctypes (caster_dta_torch/ops/cuda_segment.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int K2_THREADS = 256;          // gather_rows_kernel: a vector a thread
constexpr int K2_MAX_BLOCKS = 132 * 32;  // grid-stride beyond this
constexpr int K2_RUN_THREADS = 128;      // gather_runs_kernel: a block of 4 warps
constexpr int K2_RUN_BLOCKS = 132 * 16;  // grid-stride beyond this
constexpr int K2_RUNS = 2048;            // runs a launch aims at (k2_run_rows)
constexpr int K2_STAGE_THREADS = 512;    // gather_staged_kernel: a block per 128 edges
constexpr int K2_STAGE_ROWS = 128;       // output rows a block copies
constexpr int K2_STAGE_BYTES = 16384;    // the most bytes of a graph's table a block stages
constexpr int K3_WALK = 64;      // ids per walker that the CSR build aims at
constexpr int K3_CLUSTER = 8;    // most blocks per graph in the CSR build (portable)
constexpr int K3_WAVE = 66;      // CSR blocks over all graphs, at most, where B allows
constexpr int K3_AHEAD = 4;      // chunks of 32 ids a walker has in flight
constexpr int K3_CSR_SMEM = 232448 - 1024;  // dynamic shared memory of the CSR build
constexpr int K3_LONG = 64;      // a row of more ids takes the long path
constexpr int K3_LONG_SLOTS = 4; // blocks per graph for the long rows
constexpr int K3_SUM_THREADS = 1024;
constexpr int K3_LOADERS = K3_SUM_THREADS - 32;  // warps 1-31 stage, warp 0 adds
constexpr int K3_TILE = 768;     // rows of a long row staged per buffer (<= K3_LOADERS)
constexpr int K3_LOADS = (K3_TILE * 32 + K3_LOADERS - 1) / K3_LOADERS;
constexpr int K3_SUM_SMEM = 2 * K3_TILE * 32 * 4 + 2 * K3_TILE * 4;  // 198 KB
constexpr int K3_SMALL_THREADS = 1024;  // one block per graph on the one-launch path
constexpr int K3_SMALL_LOADS = 16;       // loads in flight a thread while it stages
constexpr int K3_SMALL_ROWS = 4096;      // most rows of a graph on the one-launch path
constexpr int K7_EDGES = 256;    // edges per block
constexpr int K7_THREADS = 256;
constexpr int K7_WINDOW_BYTES = 32768;  // staged table rows per window
constexpr int WALK_THREADS = 512;  // K1 and K8: a block of 16 warps
constexpr int WALK_GROUP = 4;      // most consecutive rows a warp takes at once
constexpr int WALK_WINDOW = 16;    // message rows a lane has in flight on a short range
constexpr int WALK_SHORT = 64;     // edges one warp sums (four windows); more go to the block
constexpr int WALK_COUNT = 8;      // a search range of at most 32x this many is counted whole
constexpr int WALK_PER = 8;        // mask bytes a thread scans per pass over a long row
constexpr int WALK_SPAN = WALK_THREADS * WALK_PER;  // edges a pass compacts (4096)
constexpr int WALK_LOADERS = WALK_THREADS - 32;     // warps 1-15 stage a long row, warp 0 adds
constexpr int WALK_BLOCKS = 2;     // blocks an SM holds (registers: 64 a thread)
constexpr int WALK_TILE = 240;     // edges of a long row per stage buffer
constexpr int WALK_RING = 3;       // stage buffers: two in flight while warp 0 adds the third
constexpr int WALK_COPIES = WALK_TILE * 32 / WALK_LOADERS;  // elements a loader stages a tile
constexpr int WALK_STAGE_BYTES = WALK_RING * WALK_TILE * 32 * 4;  // f32 ring (90 KB)
static_assert(WALK_COPIES * WALK_LOADERS == WALK_TILE * 32, "a tile splits evenly over loaders");
constexpr int SMALL_FLOATS = 16384;  // a graph of at most this many message values,
constexpr int SMALL_EDGES = 512;     // edges
constexpr int SMALL_ROWS = 1024;     // and rows is summed by one block (segment_small_kernel)
constexpr int SMALL_BYTES = SMALL_FLOATS * 4 + SMALL_EDGES * 5 + (SMALL_ROWS + 1) * 4;
// K1 and K3 at rows of at most K1_NARROW_F / K3_NARROW_F columns (the
// narrow kernels): a thread per output row, a block per (graph, slice of
// rows). The cut-off is 2 by measurement on an H100: at 3 and 4 columns K3's
// narrow kernel lost to index_add_ and spilled registers, and no path runs K1
// at those widths (scripts/k1_k3_times.py --set K3_NARROW_F=4,K1_NARROW_F=4)
constexpr int K1_NARROW_F = 2;       // widest K1 row on the narrow kernel
constexpr int K3_NARROW_F = 2;       // widest K3 row on the narrow kernel
constexpr int NARROW_IPT = 8;        // most edges a thread holds (chunks of 32 a warp)
constexpr int NARROW_MIN_WARPS = 4;  // fewest warps a block (a small graph's edges spread)
constexpr int NARROW_EDGES = 32 * 32 * NARROW_IPT;  // most edges of a graph (8192)
constexpr int NARROW_SLICES = 4;     // most blocks a graph
constexpr int NARROW_SLICE_ROWS = 64;  // fewest rows a slice of more than one takes
constexpr int NARROW_SMEM = 232448 - 1024;  // most dynamic shared memory a block
constexpr int NARROW_TABLE = 33;     // K3's counts: a row's 32 warps, padded off the banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename V>
__global__ void __launch_bounds__(K2_THREADS)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx, V* __restrict__ out,
                   int64_t n_rows, int E, int N, int vec_per_row) {
  const int64_t total = n_rows * vec_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t row = t / vec_per_row;
    const int c = (int)(t - row * vec_per_row);
    const int64_t b = row / E;
    // an index outside [0, N) stops the kernel (a launch failure at the next
    // synchronisation), as the plain version raises on one
    const int src = idx[row];
    if (src < 0 || src >= N) __trap();
    out[t] = table[(b * N + src) * vec_per_row + c];
  }
}

// T: an element's bits (uint32_t for f32, uint16_t for bf16); L: one load of
// sizeof(L) / sizeof(T) elements, which divides F and the table's alignment;
// R: the rows of a run (a multiple of 8, at most 32).
template <typename T, typename L>
__global__ void __launch_bounds__(K2_RUN_THREADS)
gather_runs_kernel(const T* __restrict__ table, const int* __restrict__ idx, T* __restrict__ out,
                   int64_t n_rows, int E, int N, int F, int R) {
  constexpr int VEC = 16 / (int)sizeof(T);   // elements of a 16-byte store
  constexpr int W = (int)(sizeof(L) / sizeof(T));
  constexpr int PARTS = VEC / W;             // loads a vector
  const int lane = threadIdx.x & 31;
  // the lane's first vector of a run starts at row i0, column c0 of the run;
  // a round of the warp moves it on by 32 vectors
  const int i0 = lane * VEC / F, c0 = lane * VEC - i0 * F;
  const int step_i = 32 * VEC / F, step_c = 32 * VEC - step_i * F;
  const int64_t n_runs = (n_rows + R - 1) / R;
  const int64_t warps = (int64_t)gridDim.x * (K2_RUN_THREADS / 32);
  for (int64_t run = (int64_t)blockIdx.x * (K2_RUN_THREADS / 32) + (threadIdx.x >> 5);
       run < n_runs; run += warps) {
    const int64_t r0 = run * R;
    const int rows = (int)(n_rows - r0 < R ? n_rows - r0 : R);
    // the source row of the run's row `lane`
    int64_t src = 0;
    if (lane < rows) {
      int64_t b = r0 < INT_MAX ? (int64_t)((uint32_t)r0 / (uint32_t)E) : r0 / E;
      int e = (int)(r0 - b * E) + lane;
      while (e >= E) {
        e -= E;
        ++b;
      }
      // an index outside [0, N) stops the kernel (a launch failure at the
      // next synchronisation), as the plain version raises on one
      const int s = idx[r0 + lane];
      if (s < 0 || s >= N) __trap();
      src = b * N + s;
    }
    T* const dst = out + r0 * F;   // 16-byte aligned: r0 is a multiple of 8
    const int n_el = rows * F, n_vec = n_el / VEC;
    int i = i0, c = c0;
#pragma unroll 4
    for (int v0 = 0; v0 < n_vec; v0 += 32) {
      const bool on = v0 + lane < n_vec;
      union {
        uint4 q;
        L part[PARTS];
      } u;
      int ii = i, cc = c;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const int64_t row = __shfl_sync(0xffffffffu, src, ii & 31);
        if (on) u.part[p] = *reinterpret_cast<const L*>(table + row * F + cc);
        cc += W;
        if (cc == F) {
          cc = 0;
          ++ii;
        }
      }
      if (on) reinterpret_cast<uint4*>(dst)[v0 + lane] = u.q;
      c += step_c;
      i += step_i;
      if (c >= F) {
        c -= F;
        ++i;
      }
    }
    // a partial run's last elements, fewer than a vector
    const int tail = n_el - n_vec * VEC;
    if (tail != 0) {
      const int j = n_vec * VEC + (lane < tail ? lane : 0);
      const int ii = j / F;
      const int64_t row = __shfl_sync(0xffffffffu, src, ii & 31);
      if (lane < tail) dst[j] = table[row * F + (j - ii * F)];
    }
  }
}

// A graph's table of at most K2_STAGE_BYTES (the molecule graphs): block
// (c, b) stages graph b's whole table in shared memory with loads of L (which
// divides the table's bytes and the graph's alignment) beside the indices of
// its K2_STAGE_ROWS edges, then writes those edges' output rows, one run of
// elements, in 16-byte stores (element stores before the first 16-byte
// boundary and after the last), each element read from the staged table.
template <typename T, typename L>
__global__ void __launch_bounds__(K2_STAGE_THREADS)
gather_staged_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     T* __restrict__ out, int E, int N, int F) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int NT = K2_STAGE_THREADS;
  __shared__ __align__(16) unsigned char s_table[K2_STAGE_BYTES];
  __shared__ int s_src[K2_STAGE_ROWS];
  const T* const buf = reinterpret_cast<const T*>(s_table);
  const int b = blockIdx.y, e0 = blockIdx.x * K2_STAGE_ROWS, t = threadIdx.x;
  const int rows = min(K2_STAGE_ROWS, E - e0);
  for (int i = t; i < rows; i += NT) {
    const int src = idx[(int64_t)b * E + e0 + i];
    // an index outside [0, N) stops the kernel, as the other K2 kernels'
    if (src < 0 || src >= N) __trap();
    s_src[i] = src * F;
  }
  const L* const tb = reinterpret_cast<const L*>(table + (int64_t)b * N * F);
  const int n_loads = N * F / (int)(sizeof(L) / sizeof(T));
  for (int i = t; i < n_loads; i += NT) reinterpret_cast<L*>(s_table)[i] = tb[i];
  __syncthreads();
  // the block's output elements [0, n_el) from dst; its first 16-byte
  // boundary `head` elements in
  T* const dst = out + ((int64_t)b * E + e0) * F;
  const int n_el = rows * F;
  const int mis = (int)(reinterpret_cast<uintptr_t>(dst) % 16) / (int)sizeof(T);
  const int head = min(n_el, (VEC - mis) % VEC);
  const int n_vec = (n_el - head) / VEC;
  if (t < head) dst[t] = buf[s_src[t / F] + t % F];
  // thread t's first vector starts at row i, column c; a round of the
  // block's threads moves it on by NT vectors
  int i = (head + t * VEC) / F, c = head + t * VEC - i * F;
  const int step_i = NT * VEC / F, step_c = NT * VEC - step_i * F;
  uint4* const vdst = reinterpret_cast<uint4*>(dst + head);
  for (int v = t; v < n_vec; v += NT) {
    union {
      uint4 q;
      T x[VEC];
    } u;
    int ii = i, cc = c, row = s_src[ii];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      u.x[k] = buf[row + cc];
      if (++cc == F) {
        cc = 0;
        ++ii;
        if (k + 1 < VEC) row = s_src[ii];
      }
    }
    vdst[v] = u.q;
    c += step_c;
    i += step_i;
    if (c >= F) {
      c -= F;
      ++i;
    }
  }
  const int j = head + n_vec * VEC + t;   // the last elements, fewer than a vector
  if (j < n_el) dst[j] = buf[s_src[j / F] + j % F];
}

// The CSR of K3 in the workspace: row_ptr [B, N+1], perm [B, E], n_long [B],
// long_rows [B, N] (the rows with more than K3_LONG ids, ascending).
struct Csr {
  int* row_ptr;
  int* perm;
  int* n_long;
  int* long_rows;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A walker (one warp) goes over its ids [lo, hi) 32 at a time, in edge
// order, with the next K3_AHEAD chunks' loads in flight, calling
// step(id, valid, e0) once per chunk (id -1 where not valid).
template <typename Step>
__device__ __forceinline__ void k3_walk(const int* __restrict__ ids_b, int lo, int hi, Step step) {
  const int lane = threadIdx.x & 31;
  int next[K3_AHEAD];
#pragma unroll
  for (int j = 0; j < K3_AHEAD; ++j) {
    const int e = lo + 32 * j + lane;
    next[j] = e < hi ? ids_b[e] : -1;
  }
  for (int e0 = lo; e0 < hi; e0 += 32 * K3_AHEAD) {
#pragma unroll
    for (int j = 0; j < K3_AHEAD; ++j) {
      const int c0 = e0 + 32 * j;
      if (c0 >= hi) break;
      const int id = next[j];
      const int e = c0 + 32 * K3_AHEAD + lane;
      next[j] = e < hi ? ids_b[e] : -1;
      step(id, c0 + lane < hi, c0);
    }
  }
}

// Count a walker's ids into its row of N counts: the first lane of each group
// of equal ids among 32 adds the group's size.
__device__ __forceinline__ void k3_count(const int* __restrict__ ids_b, int lo, int hi, int N,
                                         int* counts) {
  k3_walk(ids_b, lo, hi, [&](int id, bool valid, int) {
    // an id outside [0, N) stops the kernel, as the plain version raises
    if (valid && (unsigned)id >= (unsigned)N) __trap();
    const unsigned group = __match_any_sync(0xffffffffu, id);
    if (valid && (group & lanemask_lt()) == 0) counts[id] += __popc(group);
    __syncwarp();
  });
}

// Place a walker's edges in edge order: first[id] is its next position for
// id; within 32 ids, equal ids go by lane.
__device__ __forceinline__ void k3_place(const int* __restrict__ ids_b, int lo, int hi,
                                         int* first, int* perm) {
  const int lane = threadIdx.x & 31;
  k3_walk(ids_b, lo, hi, [&](int id, bool valid, int c0) {
    const unsigned group = __match_any_sync(0xffffffffu, id);
    const int before = __popc(group & lanemask_lt());
    int at = 0;
    if (valid) {
      at = first[id];
      perm[at + before] = c0 + lane;
    }
    __syncwarp();
    if (valid && before == 0) first[id] = at + __popc(group);
    __syncwarp();
  });
}

// Exclusive scan, in place, of counts[0, n) by the whole block (each thread
// a contiguous run). Where long_rows is given, it lists in order the indices
// whose count is over K3_LONG. Returns their number to every thread.
__device__ int k3_block_scan(int* counts, int n, int* long_rows, int (*warp_sum)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int own_c = 0, own_l = 0;
  for (int i = lo; i < hi; ++i) {
    const int t = counts[i];
    own_c += t;
    own_l += t > K3_LONG;
  }
  int inc_c = own_c, inc_l = own_l;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc_c, o);
    const int y = __shfl_up_sync(0xffffffffu, inc_l, o);
    if (lane >= o) {
      inc_c += x;
      inc_l += y;
    }
  }
  if (lane == 31) {
    warp_sum[warp][0] = inc_c;
    warp_sum[warp][1] = inc_l;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the warp totals; the total in slot 32
    const int nwarps = blockDim.x >> 5;
    int c = lane < nwarps ? warp_sum[lane][0] : 0, l = lane < nwarps ? warp_sum[lane][1] : 0;
    int sc = c, sl = l;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, sc, o);
      const int y = __shfl_up_sync(0xffffffffu, sl, o);
      if (lane >= o) {
        sc += x;
        sl += y;
      }
    }
    __syncwarp();
    warp_sum[lane][0] = sc - c;
    warp_sum[lane][1] = sl - l;
    if (lane == 31) warp_sum[32][1] = sl;
  }
  __syncthreads();
  int at = warp_sum[warp][0] + inc_c - own_c, at_long = warp_sum[warp][1] + inc_l - own_l;
  const int n_long = warp_sum[32][1];
  for (int i = lo; i < hi; ++i) {
    const int t = counts[i];
    counts[i] = at;
    if (long_rows != nullptr && t > K3_LONG) long_rows[at_long++] = i;
    at += t;
  }
  __syncthreads();  // counts complete; warp_sum free again
  return n_long;
}

// The CSR of one graph per cluster of blocks. Walker w = rank * NW + warp owns
// ids [w * seg, (w + 1) * seg) and a row of N counts: in its block's shared
// memory (GLOBAL_TABLE false) or in gtable [B, NW, N] (GLOBAL_TABLE true, one
// block per graph). Shared memory also holds the block's column totals, which
// the cluster's other blocks read, and the columns' counts, scanned into
// row_ptr by every block (rank 0 writes it out).
template <bool GLOBAL_TABLE>
__global__ void __launch_bounds__(1024)
scatter_csr_kernel(const int* __restrict__ ids, Csr csr, int* __restrict__ gtable, int E, int N) {
  extern __shared__ int s_csr[];  // [NW][N] counts, [N] block totals, [N] columns, [N] bases
  __shared__ int warp_sum[33][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int walkers = n_blocks * nw;
  const int seg = (E + walkers - 1) / walkers;
  const int lo = min(E, (rank * nw + warp) * seg);
  const int hi = min(E, lo + seg);
  const int* ids_b = ids + (int64_t)b * E;
  int* rp = csr.row_ptr + (int64_t)b * (N + 1);
  int* table = GLOBAL_TABLE ? gtable + (int64_t)b * nw * N : s_csr;
  int* tot = GLOBAL_TABLE ? rp : s_csr + (int64_t)nw * N;
  int* cols = GLOBAL_TABLE ? rp : tot + N;
  int* base = cols + N;  // not used where GLOBAL_TABLE: one block, every base 0
  int* mine = table + (int64_t)warp * N;

  for (int64_t i = tid; i < (int64_t)nw * N; i += blockDim.x) table[i] = 0;
  __syncthreads();
  k3_count(ids_b, lo, hi, N, mine);
  __syncthreads();

  // each walker's count -> its offset among the block's walkers; the block's totals
  for (int n = tid; n < N; n += blockDim.x) {
    int run = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = table[(int64_t)w * N + n];
      table[(int64_t)w * N + n] = run;
      run += c;
    }
    tot[n] = run;
  }
  cluster.sync();
  // per column: the ids of the blocks before this one, and of all blocks
  for (int n = tid; n < N; n += blockDim.x) {
    int before = 0, all = 0;
#pragma unroll
    for (int r = 0; r < K3_CLUSTER; ++r) {
      if (r < n_blocks) {
        const int v = GLOBAL_TABLE ? tot[n] : cluster.map_shared_rank(&tot[0], r)[n];
        before += r < rank ? v : 0;
        all += v;
      }
    }
    if (!GLOBAL_TABLE) base[n] = before;
    cols[n] = all;
  }
  __syncthreads();
  const int n_long = k3_block_scan(cols, N, rank == 0 ? csr.long_rows + (int64_t)b * N : nullptr,
                                   warp_sum);
  if (rank == 0) {
    if (!GLOBAL_TABLE) {
      for (int n = tid; n < N; n += blockDim.x) rp[n] = cols[n];
    }
    if (tid == 0) {
      rp[N] = E;
      csr.n_long[b] = n_long;
    }
  }
  for (int n = lane; n < N; n += 32) mine[n] += cols[n] + (GLOBAL_TABLE ? 0 : base[n]);
  __syncwarp();
  k3_place(ids_b, lo, hi, mine, csr.perm + (int64_t)b * E);
  cluster.sync();  // no block leaves while another may still read its totals
}

// One block per graph, for a graph whose ids, rows (widened to f32), counts
// and CSR fit one block's shared memory (and N <= K3_SMALL_ROWS): the CSR
// and the sums in one launch. `walkers` warps count and place the ids, read
// from shared memory; warp 0 alone scans the counts; then a warp per output
// row and 32 features adds the row's staged values in edge order.
template <typename T>
__global__ void __launch_bounds__(K3_SMALL_THREADS)
scatter_small_kernel(const T* __restrict__ rows, const int* __restrict__ ids,
                     float* __restrict__ out, int E, int N, int F, int walkers) {
  // [E][F] f32 rows, then int: [E] ids, [walkers][N] counts, [N+1] row_ptr, [E] perm
  extern __shared__ float s_small[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int EF = E * F;
  float* stage = s_small;
  int* s_ids = reinterpret_cast<int*>(stage + EF);
  int* table = s_ids + E;
  int* cols = table + walkers * N;
  int* perm = cols + N + 1;
  int* mine = table + warp * N;
  const int* ids_b = ids + (int64_t)b * E;
  const T* rows_b = rows + (int64_t)b * EF;

  // the ids and the rows, K3_SMALL_LOADS loads in flight a thread
  const int id0 = tid < E ? ids_b[tid] : 0;
  for (int i0 = tid; i0 < EF; i0 += K3_SMALL_THREADS * K3_SMALL_LOADS) {
    float v[K3_SMALL_LOADS];
#pragma unroll
    for (int u = 0; u < K3_SMALL_LOADS; ++u)
      v[u] = to_f32(rows_b[min(i0 + u * K3_SMALL_THREADS, EF - 1)]);
#pragma unroll
    for (int u = 0; u < K3_SMALL_LOADS; ++u) {
      if (i0 + u * K3_SMALL_THREADS < EF) stage[i0 + u * K3_SMALL_THREADS] = v[u];
    }
  }
  for (int i = tid; i < E; i += K3_SMALL_THREADS) {
    const int id = i == tid ? id0 : ids_b[i];
    // an id outside [0, N) stops the kernel, as the plain version raises
    if ((unsigned)id >= (unsigned)N) __trap();
    s_ids[i] = id;
  }
  for (int i = tid; i < walkers * N; i += blockDim.x) table[i] = 0;
  __syncthreads();
  const int seg = (E + walkers - 1) / walkers;
  const int lo = min(E, warp * seg);
  const int hi = min(E, lo + seg);
  if (warp < walkers) k3_count(s_ids, lo, hi, N, mine);
  __syncthreads();
  if (warp == 0) {
    // each lane a run of columns: the walkers' counts -> their offsets within
    // the column, the column's count; then the columns scanned
    const int per = (N + 31) / 32;
    const int c_lo = min(N, lane * per), c_hi = min(N, c_lo + per);
    int own = 0;
    for (int n = c_lo; n < c_hi; ++n) {
      int run = 0;
      for (int w = 0; w < walkers; ++w) {
        const int c = table[w * N + n];
        table[w * N + n] = run;
        run += c;
      }
      cols[n] = run;
      own += run;
    }
    int inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += x;
    }
    int at = inc - own;
    for (int n = c_lo; n < c_hi; ++n) {
      const int c = cols[n];
      cols[n] = at;
      at += c;
    }
    if (lane == 31) cols[N] = E;
  }
  __syncthreads();
  if (warp < walkers) {
    for (int n = lane; n < N; n += 32) mine[n] += cols[n];
    __syncwarp();
    k3_place(s_ids, lo, hi, mine, perm);
  }
  __syncthreads();

  // a warp per (row, 32 features): a hot row's feature tiles go to different warps
  float* out_b = out + (int64_t)b * N * F;
  const int tiles = (F + 31) / 32;
  for (int unit = warp; unit < N * tiles; unit += blockDim.x >> 5) {
    const int n = unit / tiles;
    const int f = (unit - n * tiles) * 32 + lane;
    if (f < F) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = cols[n]; i < cols[n + 1]; ++i) acc += stage[perm[i] * F + f];
      out_b[(int64_t)n * F + f] = acc;
    }
  }
}

// Warps 1-31 stage rows [t * K3_TILE, ...) of a long row's CSR range, features
// [c0, c0 + fw), widened to f32, into stage[i * 32 + f]; warp 0 does not take
// part. The tile's perm entries are in s_perm[t & 1] (put there by the call
// for tile t - 2, or before tile 0); this call fetches those of tile t + 2
// while its rows are in flight. Every row load is issued (indices clamped
// into range) before any store.
template <typename T>
__device__ __forceinline__ void k3_stage_tile(const T* __restrict__ rows_b,
                                              const int* __restrict__ perm_row, int count,
                                              int t, int F, int c0, int fw, float* stage,
                                              int* s_perm) {
  const int u = threadIdx.x - 32;
  const int len = min(K3_TILE, count - t * K3_TILE);
  int* sp = s_perm + (t & 1) * K3_TILE;
  asm volatile("bar.sync 1, %0;" ::"r"(K3_LOADERS));  // sp holds this tile's entries
  float v[K3_LOADS];
#pragma unroll
  for (int k = 0; k < K3_LOADS; ++k) {
    const int q = u + k * K3_LOADERS;
    const int i = min(q >> 5, len - 1), f = min(q & 31, fw - 1);
    v[k] = to_f32(rows_b[(int64_t)sp[i] * F + c0 + f]);
  }
  const int ahead = (t + 2) * K3_TILE + u;
  const int p = u < K3_TILE && ahead < count ? perm_row[ahead] : 0;
#pragma unroll
  for (int k = 0; k < K3_LOADS; ++k) {
    const int q = u + k * K3_LOADERS;
    if ((q >> 5) < len) stage[q] = v[k];
  }
  asm volatile("bar.sync 1, %0;" ::"r"(K3_LOADERS));  // every loader is done with sp
  if (u < K3_TILE && ahead < count) sp[u] = p;
}

// Warp 0 adds len staged values (stride 32) to acc in order, loading the next
// 16 while it adds the current 16.
__device__ __forceinline__ float k3_chain(const float* st, int len, float acc) {
  float cur[16], nxt[16];
  int i = 0;
  if (len >= 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) cur[u] = st[u * 32];
    for (; i + 32 <= len; i += 16) {
#pragma unroll
      for (int u = 0; u < 16; ++u) nxt[u] = st[(i + 16 + u) * 32];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += cur[u];
#pragma unroll
      for (int u = 0; u < 16; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc += cur[u];
    i += 16;
  }
  for (; i < len; ++i) acc += st[i * 32];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(K3_SUM_THREADS, 1)
scatter_sum_kernel(const T* __restrict__ rows, Csr csr, float* __restrict__ out, int B, int E,
                   int N, int F, int long_slots) {
  extern __shared__ float s_stage[];  // [2][K3_TILE][32] f32, then [2][K3_TILE] int
  const int b = blockIdx.x % B;
  const int slot = blockIdx.x / B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* rp = csr.row_ptr + (int64_t)b * (N + 1);
  const int* perm_b = csr.perm + (int64_t)b * E;
  const T* rows_b = rows + (int64_t)b * E * F;
  float* out_b = out + (int64_t)b * N * F;

  if (slot < long_slots) {
    // the long rows: slot j takes long rows j, j + long_slots, ...
    int* s_perm = reinterpret_cast<int*>(s_stage + 2 * K3_TILE * 32);
    const int n_long = csr.n_long[b];
    for (int j = slot; j < n_long; j += long_slots) {
      const int n = csr.long_rows[(int64_t)b * N + j];
      const int count = rp[n + 1] - rp[n];
      const int* perm_row = perm_b + rp[n];
      const int tiles = (count + K3_TILE - 1) / K3_TILE;
      for (int c0 = 0; c0 < F; c0 += 32) {
        const int fw = min(32, F - c0);
        float acc = 0.f;
        if (warp != 0) {
          for (int i = threadIdx.x - 32; i < min(2 * K3_TILE, count); i += K3_LOADERS)
            s_perm[i] = perm_row[i];  // the entries of tiles 0 and 1
          k3_stage_tile(rows_b, perm_row, count, 0, F, c0, fw, s_stage, s_perm);
        }
        __syncthreads();
        for (int t = 0; t < tiles; ++t) {
          const int buf = t & 1;
          if (warp != 0) {
            if (t + 1 < tiles)
              k3_stage_tile(rows_b, perm_row, count, t + 1, F, c0, fw,
                            s_stage + (buf ^ 1) * K3_TILE * 32, s_perm);
          } else {
            // the row's ids in edge order, one f32 add each
            acc = k3_chain(s_stage + buf * K3_TILE * 32 + lane,
                           min(K3_TILE, count - t * K3_TILE), acc);
          }
          __syncthreads();  // the next tile's stage overwrites this buffer's pair
        }
        if (warp == 0 && lane < fw) out_b[(int64_t)n * F + c0 + lane] = acc;
      }
    }
    return;
  }

  // a short row (at most K3_LONG ids) per warp; lanes own features
  const int n = (slot - long_slots) * (K3_SUM_THREADS / 32) + warp;
  if (n >= N) return;
  const int lo = rp[n];
  const int count = rp[n + 1] - lo;
  if (count > K3_LONG) return;
  const int e_a = lane < count ? perm_b[lo + lane] : 0;
  const int e_b = lane + 32 < count ? perm_b[lo + 32 + lane] : 0;
  for (int c0 = 0; c0 < F; c0 += 32) {
    const int f = min(c0 + lane, F - 1);
    float acc = 0.f;
    for (int i0 = 0; i0 < count; i0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = min(i0 + u, count - 1);
        const int e = __shfl_sync(0xffffffffu, i < 32 ? e_a : e_b, i & 31);
        v[u] = to_f32(rows_b[(int64_t)e * F + f]);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (i0 + u < count) acc += v[u];
      }
    }
    if (c0 + lane < F) out_b[(int64_t)n * F + c0 + lane] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(K7_THREADS)
gather_windowed_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                       V* __restrict__ out, int E, int N, int vec_per_row, int window_rows) {
  __shared__ int s_idx[K7_EDGES];
  __shared__ int warp_lo[K7_THREADS / 32], warp_hi[K7_THREADS / 32];
  __shared__ __align__(16) unsigned char s_window[K7_WINDOW_BYTES];
  V* window = reinterpret_cast<V*>(s_window);
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * K7_EDGES;
  const int n_e = min(K7_EDGES, E - e0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < n_e; i += K7_THREADS) {
    const int src = idx[(int64_t)b * E + e0 + i];
    // an index outside [0, N) stops the kernel, as K2's does
    if (src < 0 || src >= N) __trap();
    s_idx[i] = src;
    lo = min(lo, src);
    hi = max(hi, src);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < K7_THREADS / 32; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }

  const V* table_b = table + (int64_t)b * N * vec_per_row;
  V* out_c = out + ((int64_t)b * E + e0) * vec_per_row;
  for (int w0 = lo; w0 <= hi; w0 += window_rows) {
    const int n_rows = min(window_rows, hi + 1 - w0);
    const V* rows = table_b + (int64_t)w0 * vec_per_row;
    for (int i = threadIdx.x; i < n_rows * vec_per_row; i += K7_THREADS) window[i] = rows[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n_e * vec_per_row; i += K7_THREADS) {
      const int e = i / vec_per_row;
      const int r = s_idx[e] - w0;
      if (r >= 0 && r < n_rows) out_c[i] = window[r * vec_per_row + (i - e * vec_per_row)];
    }
    __syncthreads();  // the next window overwrites this one
  }
}

// lb(k), the first position of dst_b[lo, hi) (sorted ascending) whose value
// is >= k, for KEYS keys at once: the warp's lanes form KEYS groups, and group
// g searches key0 + g * stride, (32 / KEYS)-ary, one probe a lane a round.
// Each group keeps its answer in [a, z] and cuts that range to under a
// (32 / KEYS)th a round: with two keys, 3 rounds for 4096 edges, 4 for 65,536.
// Returns to each lane its group's answer.
template <int KEYS>
__device__ __forceinline__ int walk_bounds(const int* __restrict__ dst_b, int lo, int hi,
                                           int key0, int stride) {
  constexpr int W = 32 / KEYS;
  constexpr unsigned GROUP_BITS = W == 32 ? 0xffffffffu : (1u << W) - 1;
  const int lane = threadIdx.x & 31;
  const int g = lane / W;
  const int key = key0 + g * stride;
  if (hi - lo <= 32 * WALK_COUNT) {
    // a short range: every lane reads WALK_COUNT entries at once and the warp
    // counts the entries below each key (one round of loads)
    int below[KEYS];
#pragma unroll
    for (int k = 0; k < KEYS; ++k) below[k] = 0;
#pragma unroll
    for (int j = 0; j < WALK_COUNT; ++j) {
      const int i = lo + j * 32 + lane;
      const int d = i < hi ? dst_b[i] : INT_MAX;
#pragma unroll
      for (int k = 0; k < KEYS; ++k) below[k] += d < key0 + k * stride;
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < KEYS; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) below[k] += __shfl_xor_sync(0xffffffffu, below[k], o);
      mine = g == k ? below[k] : mine;
    }
    return lo + mine;
  }
  int a = lo, z = hi;
  while (__any_sync(0xffffffffu, z > a)) {
    const int size = z - a;
    const int step = (size + W - 1) / W;
    const int p = a + (lane % W + 1) * step - 1;
    const bool below = size > 0 && p < z && dst_b[p] < key;
    const int k = __popc((__ballot_sync(0xffffffffu, below) >> (g * W)) & GROUP_BITS);
    if (size > 0) {
      z = min(z, a + (k + 1) * step - 1);
      a += k * step;
    }
  }
  return a;
}

// Rows [r0, r1) whose edges [lo, lo + count) number at most WALK_SHORT,
// summed by one warp: lane f owns feature c0 + f. The range's dst and mask,
// WALK_SHORT / 32 entries a lane, give two bit masks over its edges: the real
// ones, and the last edge of each row. The rows are zeroed first (a row with
// no real edge stays 0); then the message rows go out WALK_WINDOW at a time
// (clamped, unconditional loads; none for a window without a real edge, such
// as a masked padding row's) and the warp walks them in edge order with one
// sum: a real edge adds to it, and a row's last edge writes it out and
// restarts it. Per edge that is a load, an add and two tests of a uniform bit.
template <typename T, bool MASKED>
__device__ __forceinline__ void walk_group(const T* __restrict__ msgs_b,
                                           const int* __restrict__ dst_b,
                                           const uint8_t* __restrict__ mask_b,
                                           float* __restrict__ out_b, int r0, int r1, int lo,
                                           int count, int F) {
  constexpr int WORDS = WALK_SHORT / 32;
  const int lane = threadIdx.x & 31;
  float v[WALK_WINDOW];
  const auto load = [&](int c0, int i0) {
    const T* col = msgs_b + (int64_t)lo * F + min(c0 + lane, F - 1);
#pragma unroll
    for (int u = 0; u < WALK_WINDOW; ++u) v[u] = to_f32(col[(int64_t)min(i0 + u, count - 1) * F]);
  };
  if (count > 0) load(0, 0);  // the first window goes out beside dst and mask
  int d[WORDS];
  unsigned reals[WORDS], ends[WORDS];
#pragma unroll
  for (int h = 0; h < WORDS; ++h) {
    const int i = h * 32 + lane;
    d[h] = i < count ? dst_b[lo + i] : -1;
    reals[h] = __ballot_sync(0xffffffffu, i < count && (!MASKED || mask_b[lo + i] != 0));
  }
  // edge i is its row's last where edge i + 1 lies in another row or past the range
#pragma unroll
  for (int h = 0; h < WORDS; ++h) {
    const int after = __shfl_down_sync(0xffffffffu, d[h], 1);
    const int next = __shfl_sync(0xffffffffu, h + 1 < WORDS ? d[h + 1 < WORDS ? h + 1 : h] : -1, 0);
    ends[h] = __ballot_sync(0xffffffffu, h * 32 + lane < count && (lane == 31 ? next : after) != d[h]);
  }
  for (int c0 = 0; c0 < F; c0 += 32) {
    const bool own = c0 + lane < F;
    for (int r = r0; r < r1; ++r) {
      if (own) out_b[(int64_t)r * F + c0 + lane] = 0.f;
    }
    float acc = 0.f;
    for (int i0 = 0; i0 < count; i0 += WALK_WINDOW) {
      const int h = i0 >> 5;
      int rows = d[0];
      unsigned real = reals[0], end = ends[0];
#pragma unroll
      for (int k = 1; k < WORDS; ++k) {
        rows = h == k ? d[k] : rows;
        real = h == k ? reals[k] : real;
        end = h == k ? ends[k] : end;
      }
      const unsigned window = (1u << WALK_WINDOW) - 1;
      real = (real >> (i0 & 31)) & window;
      end = (end >> (i0 & 31)) & window;
      if (c0 != 0 || i0 != 0) {
        if ((real | end) == 0) continue;
        if (real != 0) load(c0, i0);
      }
#pragma unroll
      for (int u = 0; u < WALK_WINDOW; ++u) {
        if ((real >> u) & 1u) acc += v[u];
        if ((end >> u) & 1u) {
          const int row = __shfl_sync(0xffffffffu, rows, (i0 + u) & 31);
          if (own) out_b[(int64_t)row * F + c0 + lane] = acc;
          acc = 0.f;
        }
      }
    }
  }
}

// The real edges of [s, s_end) (at most WALK_SPAN), in edge order, into
// list; returns their number to every thread of the block. Thread t scans
// the WALK_PER mask bytes from s + t * WALK_PER. A pass with no real edge
// (the padding row) costs one barrier.
__device__ int walk_compact(const uint8_t* __restrict__ mask_b, int s, int s_end, int* list,
                            int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = s + (int)threadIdx.x * WALK_PER;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < WALK_PER; ++j) {
    const int e = first + j;
    const bool m = mask_b[min(e, s_end - 1)] != 0;
    if (e < s_end && m) bits |= 1u << j;
  }
  if (!__syncthreads_or(bits != 0)) return 0;
  const int own = __popc(bits);
  int inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) warp_count[warp] = inc;
  __syncthreads();
  int at = inc - own, total = 0;
#pragma unroll
  for (int w = 0; w < WALK_THREADS / 32; ++w) {
    const int c = warp_count[w];
    at += w < warp ? c : 0;
    total += c;
  }
  for (; bits != 0; bits &= bits - 1) list[at++] = first + __ffs(bits) - 1;
  __syncthreads();  // the list is whole; warp_count free again
  return total;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most WALK_RING - 2 of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(WALK_RING - 2) : "memory");
}

// Warps 1-15 stage the message rows of entries [i0, i0 + len) of a long
// row's list (its real edges; for K8 the edges from s on), features
// [c0, c0 + fw), as f32 into buf[i * 32 + f]. f32 messages go by cp.async,
// straight into shared memory, so a loader keeps a whole tile in flight
// without registers; bf16 ones are loaded (every load issued, indices
// clamped, before any store), widened and stored.
template <typename T, bool MASKED>
__device__ __forceinline__ void walk_issue(const T* __restrict__ msgs_b, const int* list, int s,
                                           int i0, int len, int F, int c0, int fw, float* buf) {
  const int loader = threadIdx.x - 32;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < WALK_COPIES; ++k) {
      const int q = loader + k * WALK_LOADERS;
      const int i = q >> 5, f = q & 31;
      if (i < len && f < fw) {
        const int e = MASKED ? list[i0 + i] : s + i0 + i;
        cp_async4(buf + q, reinterpret_cast<const float*>(msgs_b) + (int64_t)e * F + c0 + f);
      }
    }
  } else {
    float v[WALK_COPIES];
#pragma unroll
    for (int k = 0; k < WALK_COPIES; ++k) {
      const int q = loader + k * WALK_LOADERS;
      const int i = i0 + min(q >> 5, len - 1);
      const int e = MASKED ? list[i] : s + i;
      v[k] = to_f32(msgs_b[(int64_t)e * F + c0 + min(q & 31, fw - 1)]);
    }
#pragma unroll
    for (int k = 0; k < WALK_COPIES; ++k) {
      const int q = loader + k * WALK_LOADERS;
      if ((q >> 5) < len) buf[q] = v[k];
    }
  }
}

// K1 (MASKED) and K8: one block per (graph, tile of 16 * group rows), group
// at most WALK_GROUP (the wrapper takes fewer rows a warp where the graphs
// give too few blocks to fill the card). Each warp takes group consecutive
// rows and finds their edge range with one search: one walk_group where the
// range holds at most WALK_SHORT edges; else it finds the inner bounds too
// and walks runs of short rows, noting each row of more than WALK_SHORT
// edges for the block. Then the block takes the noted rows one at a time.
// Dynamic shared memory: the ring, then (K1) the list.
template <typename T, bool MASKED>
__global__ void __launch_bounds__(WALK_THREADS, WALK_BLOCKS)
segment_walk_kernel(const T* __restrict__ msgs, const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask, float* __restrict__ out, int E, int N,
                    int F, int group) {
  extern __shared__ float walk_smem[];
  __shared__ int2 long_rows[WALK_GROUP * WALK_THREADS / 32];
  __shared__ int warp_count[WALK_THREADS / 32];
  float* stage = walk_smem;
  int* list = reinterpret_cast<int*>(walk_smem + WALK_RING * WALK_TILE * 32);
  const int b = blockIdx.y;
  const int rows = group * (WALK_THREADS / 32);
  const int n0 = blockIdx.x * rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* msgs_b = msgs + (int64_t)b * E * F;
  const uint8_t* mask_b = MASKED ? mask + (int64_t)b * E : nullptr;
  float* out_b = out + (int64_t)b * N * F;
  const int* dst_b = dst + (int64_t)b * E;

  const int g0 = n0 + warp * group;
  const int g1 = min(N, g0 + group);
  if (lane < group) long_rows[warp * group + lane] = make_int2(0, -1);  // y < 0: none
  if (g0 < g1) {
    const int ends = walk_bounds<2>(dst_b, 0, E, g0, group);
    const int lo = __shfl_sync(0xffffffffu, ends, 0), hi = __shfl_sync(0xffffffffu, ends, 16);
    const bool whole = hi - lo <= WALK_SHORT;
    // lane k (k <= group) holds lb(g0 + k) where the range is not whole
    int bound = lane == 0 ? lo : hi;
    if (!whole) {
      const int inner = walk_bounds<WALK_GROUP>(dst_b, lo, hi, g0 + 1, 1);
      const int from = __shfl_sync(0xffffffffu, inner,
                                   (max(lane, 1) - 1) % WALK_GROUP * (32 / WALK_GROUP));
      if (lane > 0) bound = from;
    }
    int r = g0;
    while (r < g1) {
      // the run [r, r_end) of rows: as many short rows as fit WALK_SHORT edges
      const int start = __shfl_sync(0xffffffffu, bound, r - g0);
      int r_end = g1, end = hi;
      if (!whole) {
        r_end = r;
        end = start;
        while (r_end < g1) {
          const int e = __shfl_sync(0xffffffffu, bound, r_end + 1 - g0);
          if (e - end > WALK_SHORT || e - start > WALK_SHORT) break;
          ++r_end;
          end = e;
        }
        if (r_end == r) {  // row r is long: the block sums it below
          end = __shfl_sync(0xffffffffu, bound, r + 1 - g0);
          if (lane == 0) long_rows[r - n0] = make_int2(start, end);
          r += 1;
          continue;
        }
      }
      walk_group<T, MASKED>(msgs_b, dst_b, mask_b, out_b, r, r_end, start, end - start, F);
      r = r_end;
    }
  }
  __syncthreads();

  for (int k = 0; k < rows; ++k) {
    const int2 range = long_rows[k];
    if (range.y < 0) continue;
    float* out_row = out_b + (int64_t)(n0 + k) * F;
    for (int c0 = 0; c0 < F; c0 += 32) {
      const int fw = min(32, F - c0);
      float acc = 0.f;
      for (int s = range.x; s < range.y;) {
        const int s_end = MASKED ? min(range.y, s + WALK_SPAN) : range.y;
        const int total = MASKED ? walk_compact(mask_b, s, s_end, list, warp_count) : s_end - s;
        const int tiles = (total + WALK_TILE - 1) / WALK_TILE;
        if (tiles > 0) {
          // a ring of WALK_RING tiles: warps 1-15 keep the next ones in
          // flight while warp 0 adds the oldest, one barrier a tile
          if (warp != 0) {
            for (int t = 0; t < WALK_RING - 1; ++t) {
              if (t < tiles)
                walk_issue<T, MASKED>(msgs_b, list, s, t * WALK_TILE,
                                      min(WALK_TILE, total - t * WALK_TILE), F, c0, fw,
                                      stage + t * WALK_TILE * 32);
              cp_async_commit();
            }
          }
          for (int t = 0; t < tiles; ++t) {
            if (warp != 0) cp_async_wait_ring();
            __syncthreads();  // tile t is staged; tile t - 1's buffer is free
            if (warp != 0) {
              const int next = t + WALK_RING - 1;
              if (next < tiles)
                walk_issue<T, MASKED>(msgs_b, list, s, next * WALK_TILE,
                                      min(WALK_TILE, total - next * WALK_TILE), F, c0, fw,
                                      stage + (next % WALK_RING) * WALK_TILE * 32);
              cp_async_commit();
            } else {
              // the row's real edges in edge order, one f32 add each
              acc = k3_chain(stage + (t % WALK_RING) * WALK_TILE * 32 + lane,
                             min(WALK_TILE, total - t * WALK_TILE), acc);
            }
          }
          __syncthreads();  // the ring is free again
        }
        s = s_end;
      }
      if (warp == 0 && lane < fw) out_row[c0 + lane] = acc;
    }
  }
}

template <typename V>
void launch_gather(const void* table, const void* idx, void* out, int B, int E, int N,
                   int row_bytes, cudaStream_t stream) {
  const int vec_per_row = row_bytes / (int)sizeof(V);
  const int64_t n_rows = (int64_t)B * E;
  const int64_t total = n_rows * vec_per_row;
  int64_t blocks = (total + K2_THREADS - 1) / K2_THREADS;
  if (blocks > K2_MAX_BLOCKS) blocks = K2_MAX_BLOCKS;
  gather_rows_kernel<V><<<(unsigned)blocks, K2_THREADS, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx), static_cast<V*>(out),
      n_rows, E, N, vec_per_row);
}

// The rows of gather_runs_kernel's runs for n_rows output rows: 8, 16 or 32
// (a run of 8 rows starts 16-byte aligned; at most an index a lane), the
// fewest that leave at most K2_RUNS runs, so that a small gather still has
// enough warps in flight and a large one copies long runs. On an H100 this
// chose the fastest of 8, 16 and 32 at every shape scripts/k2_times.py times
// (4 was never the fastest): 8 for 8,192 rows of 51 columns, 16 for 32,768,
// 32 for 131,072 rows of 21.
int k2_run_rows(int64_t n_rows) {
  return n_rows <= 8 * K2_RUNS ? 8 : n_rows <= 16 * K2_RUNS ? 16 : 32;
}

template <typename T, typename L>
int launch_gather_staged(const void* table, const void* idx, void* out, int B, int E, int N,
                         int F, cudaStream_t stream) {
  // as much of each SM as shared memory as the blocks can use, whatever
  // the kernels before left the split between L1 and shared memory at
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(gather_staged_kernel<T, L>,
                                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((E + K2_STAGE_ROWS - 1) / K2_STAGE_ROWS, B);
  gather_staged_kernel<T, L><<<grid, K2_STAGE_THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), E, N, F);
  return 0;
}

template <typename T, typename L>
void launch_gather_runs(const void* table, const void* idx, void* out, int B, int E, int N, int F,
                        cudaStream_t stream) {
  const int64_t n_rows = (int64_t)B * E;
  const int R = k2_run_rows(n_rows);
  const int64_t runs = (n_rows + R - 1) / R;
  int64_t blocks = (runs + K2_RUN_THREADS / 32 - 1) / (K2_RUN_THREADS / 32);
  if (blocks > K2_RUN_BLOCKS) blocks = K2_RUN_BLOCKS;
  gather_runs_kernel<T, L><<<(unsigned)blocks, K2_RUN_THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), n_rows, E,
      N, F, R);
}

template <typename V>
void launch_gather_windowed(const void* table, const void* idx, void* out, int B, int E, int N,
                            int row_bytes, cudaStream_t stream) {
  const int vec_per_row = row_bytes / (int)sizeof(V);
  const dim3 grid((E + K7_EDGES - 1) / K7_EDGES, B);
  gather_windowed_kernel<V><<<grid, K7_THREADS, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx), static_cast<V*>(out), E, N,
      vec_per_row, K7_WINDOW_BYTES / row_bytes);
}

// How the CSR build of one graph is cut: a cluster of `blocks` blocks of
// `warps` walkers, the counts in shared memory unless N of them do not fit.
struct K3Plan {
  int blocks;
  int warps;
  bool global_table;
};

K3Plan k3_plan(int B, int E, int N) {
  const int want = max(1, (E + K3_WALK - 1) / K3_WALK);  // walkers
  K3Plan p;
  // clusters of more blocks than fit the card at once start in waves
  p.blocks = max(1, min(min(K3_CLUSTER, K3_WAVE / max(B, 1)), (want + 31) / 32));
  const int fit = K3_CSR_SMEM / 4 / max(N, 1) - 3;  // besides totals, columns and bases
  p.global_table = fit < 1;
  if (p.global_table) {
    p.blocks = 1;
    p.warps = min(32, want);
  } else {
    p.warps = min(min(32, (want + p.blocks - 1) / p.blocks), fit);
  }
  return p;
}

// The long rows are few: one block per graph for a small graph, up to
// K3_LONG_SLOTS for a large one.
int k3_long_slots(int E) { return min(K3_LONG_SLOTS, max(1, E / 2048)); }

Csr k3_csr(void* ws, int B, int E, int N) {
  int* p = static_cast<int*>(ws);
  Csr c;
  c.row_ptr = p;
  c.perm = c.row_ptr + (int64_t)B * (N + 1);
  c.n_long = c.perm + (int64_t)B * E;
  c.long_rows = c.n_long + B;
  return c;
}

int k3_launch_csr(const void* ids, void* ws, int B, int E, int N, cudaStream_t s) {
  const K3Plan p = k3_plan(B, E, N);
  const Csr csr = k3_csr(ws, B, E, N);
  int* gtable = csr.long_rows + (int64_t)B * N;  // [B, walkers, N] where global_table
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, B);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const int* ids_i = static_cast<const int*>(ids);
  cudaError_t err;
  if (p.global_table) {
    err = cudaLaunchKernelEx(&cfg, scatter_csr_kernel<true>, ids_i, csr, gtable, E, N);
  } else {
    static bool attr = false;
    if (!attr) {
      err = cudaFuncSetAttribute(scatter_csr_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, K3_CSR_SMEM);
      if (err != cudaSuccess) return (int)err;
      attr = true;
    }
    cfg.dynamicSmemBytes = (size_t)(p.warps + 3) * N * sizeof(int);
    err = cudaLaunchKernelEx(&cfg, scatter_csr_kernel<false>, ids_i, csr, gtable, E, N);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

int k3_small_walkers(int E) { return min(32, max(1, (E + K3_WALK - 1) / K3_WALK)); }

// The one-launch path: a graph of at most K3_SMALL_ROWS rows whose f32 rows,
// ids, counts, row pointers and permutation fit one block's shared memory.
// Returns its bytes, else 0.
size_t k3_small_bytes(int E, int N, int F) {
  const int64_t ints = (int64_t)E * F + 2LL * E + (int64_t)k3_small_walkers(E) * N + N + 1;
  return N <= K3_SMALL_ROWS && ints * 4 <= K3_CSR_SMEM ? (size_t)ints * 4 : 0;
}

template <typename T>
int k3_launch_small(const void* rows, const void* ids, void* out, int B, int E, int N, int F,
                    size_t bytes, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_CSR_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  scatter_small_kernel<T><<<B, K3_SMALL_THREADS, bytes, s>>>(
      static_cast<const T*>(rows), static_cast<const int*>(ids), static_cast<float*>(out), E, N,
      F, k3_small_walkers(E));
  return (int)cudaGetLastError();
}

template <typename T>
int k3_launch_sum(const void* rows, void* ws, void* out, int B, int E, int N, int F,
                  cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SUM_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int slots = k3_long_slots(E);
  const int64_t blocks = (int64_t)(slots + (N + 31) / 32) * B;
  scatter_sum_kernel<T><<<(unsigned)blocks, K3_SUM_THREADS, K3_SUM_SMEM, s>>>(
      static_cast<const T*>(rows), k3_csr(ws, B, E, N), static_cast<float*>(out), B, E, N, F,
      slots);
  return (int)cudaGetLastError();
}

// K1 (MASKED) and K8 for a small graph (the molecules): one block per graph
// stages all of its messages (as f32), dst and mask in shared memory with
// one round of loads (every load issued before any store), finds each row's
// range from the row starts among the staged dst, and a warp per row adds
// the row's real edges, found 32 at a time by a ballot on the staged mask, in
// edge order. A masked padding row costs a ballot per 32 edges.
template <typename T, bool MASKED>
__global__ void __launch_bounds__(WALK_THREADS)
segment_small_kernel(const T* __restrict__ msgs, const int* __restrict__ dst,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, int E, int N,
                     int F) {
  extern __shared__ float small_smem[];
  float* s_msgs = small_smem;                                         // [E * F]
  int* s_dst = reinterpret_cast<int*>(small_smem + SMALL_FLOATS);     // [E]
  int* s_ptr = s_dst + SMALL_EDGES;                                   // [N + 1]: lb(n)
  uint8_t* s_real = reinterpret_cast<uint8_t*>(s_ptr + SMALL_ROWS + 1);  // [E]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int EF = E * F;
  const T* msgs_b = msgs + (int64_t)b * EF;
  float* out_b = out + (int64_t)b * N * F;
  const int* dst_b = dst + (int64_t)b * E;

  float v[SMALL_FLOATS / WALK_THREADS];
#pragma unroll
  for (int k = 0; k < SMALL_FLOATS / WALK_THREADS; ++k) {
    const int i = k * WALK_THREADS + tid;
    v[k] = i < EF ? to_f32(msgs_b[i]) : 0.f;
  }
  const int d = tid < E ? dst_b[tid] : 0;
  const bool real = tid < E && (!MASKED || mask[(int64_t)b * E + tid] != 0);
#pragma unroll
  for (int k = 0; k < SMALL_FLOATS / WALK_THREADS; ++k) {
    const int i = k * WALK_THREADS + tid;
    if (i < EF) s_msgs[i] = v[k];
  }
  if (tid < E) {
    s_dst[tid] = d;
    s_real[tid] = real;
  }
  for (int r = tid; r <= N; r += WALK_THREADS) s_ptr[r] = E;  // rows past the last edge
  __syncthreads();
  if (tid < E) {  // edge tid starts the rows (dst[tid - 1], dst[tid]]
    const int prev = tid > 0 ? s_dst[tid - 1] : -1;
    for (int r = prev + 1; r <= min(d, N); ++r) s_ptr[r] = tid;
  }
  __syncthreads();

  for (int r = warp; r < N; r += WALK_THREADS / 32) {
    const int rb = s_ptr[r], re = s_ptr[r + 1];
    for (int c0 = 0; c0 < F; c0 += 32) {
      const int f = min(c0 + lane, F - 1);
      float acc = 0.f;
      for (int i0 = rb; i0 < re; i0 += 32) {
        for (unsigned bits = __ballot_sync(0xffffffffu, i0 + lane < re && s_real[i0 + lane]);
             bits != 0; bits &= bits - 1) {
          acc += s_msgs[(i0 + __ffs(bits) - 1) * F + f];
        }
      }
      if (c0 + lane < F) out_b[(int64_t)r * F + c0 + lane] = acc;
    }
  }
}

// A graph the one-block path takes: its messages, dst, mask and row bounds
// fit SMALL_BYTES of shared memory.
inline bool walk_small_fits(int E, int N, int F) {
  return E <= SMALL_EDGES && N <= SMALL_ROWS && (int64_t)E * F <= SMALL_FLOATS;
}

// One launch of the walker, or of the one-block path for a small graph; the
// first call of each instantiation raises its dynamic shared memory limit.
template <typename T, bool MASKED>
int walk_launch(const void* msgs, const void* dst, const void* mask, void* out, int B, int E,
                int N, int F, cudaStream_t s) {
  if (walk_small_fits(E, N, F)) {
    static bool small_attr = false;
    if (!small_attr) {
      const cudaError_t err = cudaFuncSetAttribute(
          segment_small_kernel<T, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMALL_BYTES);
      if (err != cudaSuccess) return (int)err;
      small_attr = true;
    }
    segment_small_kernel<T, MASKED><<<B, WALK_THREADS, SMALL_BYTES, s>>>(
        static_cast<const T*>(msgs), static_cast<const int*>(dst),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out), E, N, F);
    return (int)cudaGetLastError();
  }
  const size_t bytes = WALK_STAGE_BYTES + (MASKED ? WALK_SPAN * sizeof(int) : 0);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_walk_kernel<T, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  // the most rows a warp (so the fewest blocks) that still gives every SM a block
  int group = WALK_GROUP;
  while (group > 1 && (int64_t)B * ((N + 16 * group - 1) / (16 * group)) < 132) group >>= 1;
  const int rows = 16 * group;
  const dim3 grid((N + rows - 1) / rows, B);
  segment_walk_kernel<T, MASKED><<<grid, WALK_THREADS, bytes, s>>>(
      static_cast<const T*>(msgs), static_cast<const int*>(dst),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), E, N, F, group);
  return (int)cudaGetLastError();
}

// ---- the narrow kernels: K1 and K3 at rows of one or a few columns
//
// A block per (graph, slice of slice_rows rows) of nw warps. Warp w owns the
// graph's edges [w * chunks * 32, (w + 1) * chunks * 32), 32 a chunk, lane l
// edge 32 * chunk + l, so the block's edges go in edge order by (warp,
// chunk, lane); every edge's id and F values are loaded at once, in one
// round of loads. Each block keeps the edges that fall in its slice (K3: of
// which not every value is +-0; K1: real) and lays their values out in
// shared memory by row, each row's in edge order; then thread r adds row
// r's values in order (narrow_chain). A long row (the padding row on random
// rows) is one thread's chain of dependent f32 adds, its values read 16
// bytes at a time ahead of the adds.

// The layout of a narrow launch: nw warps of chunks of 32 edges, slices
// blocks a graph of slice_rows rows each, the offset (in 4-byte words, a
// multiple of 4) of the values in its dynamic shared memory, and its bytes.
struct NarrowPlan {
  int warps;
  int chunks;
  int slices;
  int slice_rows;
  int vals_at;
  int64_t bytes;
};

NarrowPlan narrow_plan(int B, int E, int N, int F, bool k3) {
  NarrowPlan p;
  // as few warps as hold the edges at NARROW_IPT a thread, but at least
  // NARROW_MIN_WARPS: on an H100 this was the fastest of 1, 2, 4 and 8 edges
  // a thread at the zoo's protein graph (E = 4096: 16 warps) and, by 4
  // warps, at its molecule graph (E = 256)
  p.warps = min(32, max(NARROW_MIN_WARPS, (E + 32 * NARROW_IPT - 1) / (32 * NARROW_IPT)));
  p.chunks = (E + 32 * p.warps - 1) / (32 * p.warps);
  // more blocks a graph where the graphs leave SMs idle, each of at least
  // NARROW_SLICE_ROWS rows
  p.slices = max(1, min(min(NARROW_SLICES, 132 / max(B, 1)), N / NARROW_SLICE_ROWS));
  p.slice_rows = (N + p.slices - 1) / p.slices;
  // K3: [rows][NARROW_TABLE] counts and [rows + 1] starts; K1: [rows + 1]
  // starts and [E] rows of the kept edges; then [E][F] f32 values, 16-byte
  // aligned (a slice may keep every edge)
  const int64_t ints = k3 ? (int64_t)NARROW_TABLE * p.slice_rows + p.slice_rows + 1
                          : (int64_t)p.slice_rows + 1 + E;
  p.vals_at = (int)((ints + 3) / 4 * 4);
  p.bytes = ((int64_t)p.vals_at + (int64_t)E * F) * 4;
  return p;
}

bool narrow_fits(const NarrowPlan& p, int E) {
  return E <= NARROW_EDGES && p.chunks <= NARROW_IPT && p.bytes <= NARROW_SMEM;
}

// Warp 0 zeroes the entries of warp_sum past the block's nw warps, which no
// warp writes, so that narrow_warp_prefix reads all 32 unconditionally.
__device__ __forceinline__ void narrow_warp_sums_init(int* warp_sum, int nw) {
  if (threadIdx.x >= nw && threadIdx.x < 32) warp_sum[threadIdx.x] = 0;
}

// The sum of warp_sum[w] over the warps before this one, and over all 32
// (a barrier after they were written).
__device__ __forceinline__ int2 narrow_warp_prefix(const int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = warp_sum[lane];  // 0 past nw (narrow_warp_sums_init)
  int before = lane < warp ? s : 0, total = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, o);
    total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return make_int2(before, total);
}

// acc[x % F] += v[x] for x = a .. b - 1 in order (v 16-byte aligned): up to
// three values one at a time, then 16 bytes a load with the next 16 values
// in flight while the previous 16 are added (one dependent f32 add a value
// and column is the chain's floor), then the rest.
template <int F>
__device__ __forceinline__ void narrow_chain(const float* v, int a, int b, float (&acc)[F]) {
  if constexpr (4 % F != 0) {
    for (int x = a; x < b; ++x) acc[x % F] += v[x];
  } else {
    const auto add4 = [&](float4 c) {
      acc[0] += c.x;
      acc[1 % F] += c.y;
      acc[2 % F] += c.z;
      acc[3 % F] += c.w;
    };
    const int head = min(b, (a + 3) & ~3);
    for (int x = a; x < head; ++x) acc[x % F] += v[x];
    const float4* q = reinterpret_cast<const float4*>(v) + head / 4;
    const int n4 = max(0, b - head) / 4;
    int k = 0;
    if (n4 >= 4) {
      // two buffers in turn (no copies): x holds loads [k, k + 4) as the loop starts
      float4 x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = q[u];
      for (; k + 12 <= n4; k += 8) {
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = q[k + 4 + u];
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(x[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = q[k + 8 + u];
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(y[u]);
      }
      if (k + 8 <= n4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = q[k + 4 + u];
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(x[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(y[u]);
        k += 8;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) add4(x[u]);
        k += 4;
      }
    }
    for (; k < n4; ++k) add4(q[k]);
    for (int x = head + 4 * n4; x < b; ++x) acc[x % F] += v[x];
  }
}

// Thread r of the block writes out_rows[r] = the sum of row r's values,
// vals[start[r] * F, start[r + 1] * F) (rows [0, nr)).
template <int F>
__device__ __forceinline__ void narrow_sums(const float* vals, const int* start, int nr,
                                            float* __restrict__ out_rows) {
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    narrow_chain<F>(vals, start[r] * F, start[r + 1] * F, acc);
#pragma unroll
    for (int f = 0; f < F; ++f) out_rows[(int64_t)r * F + f] = acc[f];
  }
}

// K3 at rows of F <= K3_NARROW_F columns. Each warp counts its kept ids a
// row in its own column of the [nr][NARROW_TABLE] table, each edge's rank
// among its warp's edges of its row read before the count moves (no second
// pass); a row's entries become each warp's offset within the row, the rows'
// counts their starts (one scan of the block), and each kept edge writes its
// F values straight to start + offset + rank. An edge whose F values are all
// +-0 is not kept: an in-order f32 sum from +0 is never -0, so adding +-0
// leaves it as it was, and the row's bits are the plain version's either way
// (segment_softmax's cotangents are +-0 on the masked edges of the padding
// row). An id outside [0, N) traps. Shared-memory reads are unconditional
// (an index clamped into range where the value is not used): a read under a
// condition compiles to a branch, and the reads would not overlap.
template <typename T, int F>
__global__ void __launch_bounds__(1024)
scatter_narrow_kernel(const T* __restrict__ rows, const int* __restrict__ ids,
                      float* __restrict__ out, int E, int N, int chunks, int slice_rows,
                      int vals_at) {
  extern __shared__ int narrow_smem[];
  __shared__ int warp_sum[32];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * slice_rows;
  const int nr = min(N - r0, slice_rows);
  if (nr <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  narrow_warp_sums_init(warp_sum, nw);
  int* table = narrow_smem;                                  // [nr][NARROW_TABLE]
  int* start = table + NARROW_TABLE * nr;                    // [nr + 1]
  float* vals = reinterpret_cast<float*>(narrow_smem + vals_at);  // [kept][F]
  int* mine = table + warp;                                  // this warp's column
  const int* ids_b = ids + (int64_t)b * E;
  const T* rows_b = rows + (int64_t)b * E * F;

  int id[NARROW_IPT];
  float v[NARROW_IPT][F];
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    const int e = (warp * chunks + j) * 32 + lane;
    const bool ok = j < chunks && e < E;
    id[j] = ok ? ids_b[e] : -1;
#pragma unroll
    for (int f = 0; f < F; ++f) v[j][f] = ok ? to_f32(rows_b[(int64_t)e * F + f]) : 0.f;
  }
  for (int r = lane; r < nr; r += 32) mine[r * NARROW_TABLE] = 0;
  __syncwarp();

  // each kept edge's group: the lanes of its chunk with the same row (all
  // chunks' matches in flight at once, before the counts)
  unsigned group[NARROW_IPT];
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    group[j] = 0;
    if (j < chunks) {  // the same for the whole block
      const int e = (warp * chunks + j) * 32 + lane;
      // an id outside [0, N) stops the kernel, as the plain version raises
      if (e < E && (unsigned)id[j] >= (unsigned)N) __trap();
      bool nonzero = false;
#pragma unroll
      for (int f = 0; f < F; ++f) nonzero |= v[j][f] != 0.f;
      const int q = id[j] - r0;
      const bool kept = e < E && nonzero && q >= 0 && q < nr;
      id[j] = kept ? q : -1;  // from here on: the row in the slice, -1 not kept
      group[j] = __match_any_sync(0xffffffffu, id[j]);
    }
  }
  int rank[NARROW_IPT];  // among the warp's kept edges of the same row
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    rank[j] = 0;
    if (j < chunks) {
      const int before = __popc(group[j] & lanemask_lt());
      const int qq = max(id[j], 0);
      const int at = mine[qq * NARROW_TABLE];
      __syncwarp();
      if (id[j] >= 0 && before == 0) mine[qq * NARROW_TABLE] = at + __popc(group[j]);
      __syncwarp();
      rank[j] = at + before;
    }
  }
  __syncthreads();

  // per row (a thread a run of consecutive rows): the warps' counts -> each
  // warp's offset within the row, the row's count; then the counts scanned
  const int per = (nr + blockDim.x - 1) / blockDim.x;
  const int lo = min(nr, tid * per), hi = min(nr, lo + per);
  int own = 0;
  for (int r = lo; r < hi; ++r) {
    int* row = table + r * NARROW_TABLE;
    int run = 0;
    for (int w0 = 0; w0 < nw; w0 += 8) {
      int c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = row[min(w0 + k, 31)];  // in the row's NARROW_TABLE
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (w0 + k < nw) row[w0 + k] = run;
        run += c[k] * (w0 + k < nw);
      }
    }
    start[r] = run;
    own += run;
  }
  int inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  const int2 pre = narrow_warp_prefix(warp_sum);
  int at = pre.x + inc - own;
  for (int r = lo; r < hi; ++r) {
    const int c = start[r];
    start[r] = at;
    at += c;
  }
  if (tid == 0) start[nr] = pre.y;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    const int q = max(id[j], 0);
    const int p = start[q] + mine[q * NARROW_TABLE] + rank[j];
    if (id[j] >= 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) vals[p * F + f] = v[j][f];
    }
  }
  __syncthreads();
  narrow_sums<F>(vals, start, nr, out + ((int64_t)b * N + r0) * F);
}

// K1 at rows of F <= K1_NARROW_F columns: each block keeps the real edges of
// its slice's rows, compacted in edge order by a ballot a chunk and one scan
// of the warps' counts (a masked edge costs its bit of a ballot; the
// padding row has no pass of its own), beside each kept edge's row. Kept
// edge k whose row follows kept edge k - 1's starts the rows between, so
// every row's start comes from one pass over the kept edges.
template <typename T, int F>
__global__ void __launch_bounds__(1024)
segment_narrow_kernel(const T* __restrict__ msgs, const int* __restrict__ dst,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, int E, int N,
                      int chunks, int slice_rows, int vals_at) {
  extern __shared__ int narrow_smem[];
  __shared__ int warp_sum[32];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * slice_rows;
  const int nr = min(N - r0, slice_rows);
  if (nr <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  narrow_warp_sums_init(warp_sum, nw);
  int* start = narrow_smem;                                  // [nr + 1]
  int* krow = start + nr + 1;                                // [kept]
  float* vals = reinterpret_cast<float*>(narrow_smem + vals_at);  // [kept][F]
  const int* dst_b = dst + (int64_t)b * E;
  const uint8_t* mask_b = mask + (int64_t)b * E;
  const T* msgs_b = msgs + (int64_t)b * E * F;

  int q[NARROW_IPT];
  bool real[NARROW_IPT];
  float v[NARROW_IPT][F];
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    const int e = (warp * chunks + j) * 32 + lane;
    const bool ok = j < chunks && e < E;
    q[j] = ok ? dst_b[e] - r0 : -1;
    real[j] = ok && mask_b[e] != 0;
#pragma unroll
    for (int f = 0; f < F; ++f) v[j][f] = ok ? to_f32(msgs_b[(int64_t)e * F + f]) : 0.f;
  }
  unsigned kept[NARROW_IPT];
  int count = 0;
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    kept[j] = __ballot_sync(0xffffffffu, real[j] && q[j] >= 0 && q[j] < nr);
    count += __popc(kept[j]);
  }
  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  const int2 pre = narrow_warp_prefix(warp_sum);
  const int total = pre.y;
  int at = pre.x;
  int k[NARROW_IPT];  // each kept edge's place among the kept edges; -1 not kept
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    k[j] = (kept[j] >> lane) & 1u ? at + __popc(kept[j] & lanemask_lt()) : -1;
    at += __popc(kept[j]);
    if (k[j] >= 0) {
      krow[k[j]] = q[j];
#pragma unroll
      for (int f = 0; f < F; ++f) vals[k[j] * F + f] = v[j][f];
    }
  }
  __syncthreads();
  int from[NARROW_IPT];  // rows (the previous kept edge's row, q] start at k
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) from[j] = krow[max(k[j], 1) - 1] + 1;
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) from[j] = k[j] > 0 ? from[j] : 0;
#pragma unroll
  for (int j = 0; j < NARROW_IPT; ++j) {
    if (k[j] >= 0) {
      for (int r = from[j]; r <= q[j]; ++r) start[r] = k[j];
    }
  }
  // the rows past the last kept edge start (and end) at the total
  const int last = total > 0 ? krow[total - 1] : -1;
  for (int r = last + 1 + tid; r <= nr; r += blockDim.x) start[r] = total;
  __syncthreads();
  narrow_sums<F>(vals, start, nr, out + ((int64_t)b * N + r0) * F);
}

template <typename T, int F>
int k3_launch_narrow(const void* rows, const void* ids, void* out, int B, int E, int N,
                     cudaStream_t s) {
  const NarrowPlan p = narrow_plan(B, E, N, F, true);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_narrow_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, NARROW_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  scatter_narrow_kernel<T, F><<<dim3(p.slices, B), 32 * p.warps, (size_t)p.bytes, s>>>(
      static_cast<const T*>(rows), static_cast<const int*>(ids), static_cast<float*>(out), E, N,
      p.chunks, p.slice_rows, p.vals_at);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int k1_launch_narrow(const void* msgs, const void* dst, const void* mask, void* out, int B,
                     int E, int N, cudaStream_t s) {
  const NarrowPlan p = narrow_plan(B, E, N, F, false);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_narrow_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, NARROW_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  segment_narrow_kernel<T, F><<<dim3(p.slices, B), 32 * p.warps, (size_t)p.bytes, s>>>(
      static_cast<const T*>(msgs), static_cast<const int*>(dst),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), E, N, p.chunks, p.slice_rows,
      p.vals_at);
  return (int)cudaGetLastError();
}

// The narrow launch of F columns (1 <= F <= FMAX), one instance a width.
template <typename T, int FMAX>
int k3_narrow_width(const void* rows, const void* ids, void* out, int B, int E, int N, int F,
                    cudaStream_t s) {
  if (F == FMAX) return k3_launch_narrow<T, FMAX>(rows, ids, out, B, E, N, s);
  if constexpr (FMAX > 1) return k3_narrow_width<T, FMAX - 1>(rows, ids, out, B, E, N, F, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int FMAX>
int k1_narrow_width(const void* msgs, const void* dst, const void* mask, void* out, int B,
                    int E, int N, int F, cudaStream_t s) {
  if (F == FMAX) return k1_launch_narrow<T, FMAX>(msgs, dst, mask, out, B, E, N, s);
  if constexpr (FMAX > 1)
    return k1_narrow_width<T, FMAX - 1>(msgs, dst, mask, out, B, E, N, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1's kernel for B graphs of E edges into N rows of F columns: 0 the narrow
// kernel (rows of at most K1_NARROW_F columns of a graph that one block
// holds), 1 segment_small_kernel (a graph that one block stages), 2
// segment_walk_kernel (the rest).
int k1_route(int B, int E, int N, int F) {
  if (F >= 1 && F <= K1_NARROW_F && narrow_fits(narrow_plan(B, E, N, F, false), E)) return 0;
  return walk_small_fits(E, N, F) ? 1 : 2;
}

// msgs [B, E, F] f32 (msgs_bf16 == 0) or bf16 (msgs_bf16 != 0), dst [B, E]
// int32 sorted per graph, mask [B, E] bool, out [B, N, F] f32. All contiguous.
int k1_segment_sum_sorted(const void* msgs, const void* dst, const void* mask, void* out,
                          int B, int E, int N, int F, int msgs_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k1_route(B, E, N, F) == 0) {
    return msgs_bf16
               ? k1_narrow_width<__nv_bfloat16, K1_NARROW_F>(msgs, dst, mask, out, B, E, N, F, s)
               : k1_narrow_width<float, K1_NARROW_F>(msgs, dst, mask, out, B, E, N, F, s);
  }
  return msgs_bf16 ? walk_launch<__nv_bfloat16, true>(msgs, dst, mask, out, B, E, N, F, s)
                   : walk_launch<float, true>(msgs, dst, mask, out, B, E, N, F, s);
}

// The kernel K2 copies rows of F elements of elem_bytes with, loaded
// load_bytes at a time from a table of N rows a graph: 0 gather_rows_kernel
// (rows of 16-byte loads, or of one load), 2 gather_staged_kernel (other rows
// where a graph's table fits K2_STAGE_BYTES and has at most the rows a block
// writes: a block stages the whole table, so a longer one would be read many
// times over), 1 gather_runs_kernel (the rest).
int k2_kernel(int N, int F, int elem_bytes, int load_bytes) {
  if (load_bytes == 16 || (int64_t)F * elem_bytes == load_bytes) return 0;
  const bool fits = (int64_t)N * F * elem_bytes <= K2_STAGE_BYTES && N <= K2_STAGE_ROWS;
  return fits ? 2 : 1;
}

// The widest of 16, 8, 4, 2 bytes (at least elem_bytes) that divides n_bytes
// and the address p.
int widest_load(const void* p, int64_t n_bytes, int elem_bytes) {
  for (int v = 16; v > elem_bytes; v /= 2) {
    if (n_bytes % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  }
  return elem_bytes;
}

// table [B, N, F] of 2- or 4-byte elements (elem_bytes), idx [B, E] int32 in
// [0, N), out [B, E, F], 16-byte aligned. load_bytes (16, 8, 4 or 2, at least
// elem_bytes) divides F * elem_bytes and the table's alignment.
int k2_gather_rows(const void* table, const void* idx, void* out, int B, int E, int N, int F,
                   int elem_bytes, int load_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || F < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) || load_bytes < elem_bytes ||
      (int64_t)F * elem_bytes % load_bytes != 0 ||
      reinterpret_cast<uintptr_t>(table) % load_bytes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_bytes = F * elem_bytes;
  const int kernel = k2_kernel(N, F, elem_bytes, load_bytes);
  if (kernel == 2) {
    // the graph's table in loads as wide as its bytes and address allow
    const int stage = widest_load(table, (int64_t)N * row_bytes, elem_bytes);
    int err;
    if (elem_bytes == 4) {
      switch (stage) {
        case 16: err = launch_gather_staged<uint32_t, uint4>(table, idx, out, B, E, N, F, s); break;
        case 8: err = launch_gather_staged<uint32_t, uint2>(table, idx, out, B, E, N, F, s); break;
        default: err = launch_gather_staged<uint32_t, uint32_t>(table, idx, out, B, E, N, F, s);
      }
    } else {
      switch (stage) {
        case 16: err = launch_gather_staged<uint16_t, uint4>(table, idx, out, B, E, N, F, s); break;
        case 8: err = launch_gather_staged<uint16_t, uint2>(table, idx, out, B, E, N, F, s); break;
        case 4:
          err = launch_gather_staged<uint16_t, uint32_t>(table, idx, out, B, E, N, F, s);
          break;
        default: err = launch_gather_staged<uint16_t, uint16_t>(table, idx, out, B, E, N, F, s);
      }
    }
    if (err != 0) return err;
  } else if (kernel == 0) {
    switch (load_bytes) {
      case 16: launch_gather<uint4>(table, idx, out, B, E, N, row_bytes, s); break;
      case 8: launch_gather<uint2>(table, idx, out, B, E, N, row_bytes, s); break;
      case 4: launch_gather<uint32_t>(table, idx, out, B, E, N, row_bytes, s); break;
      case 2: launch_gather<uint16_t>(table, idx, out, B, E, N, row_bytes, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (elem_bytes == 4) {
    switch (load_bytes) {
      case 8: launch_gather_runs<uint32_t, uint2>(table, idx, out, B, E, N, F, s); break;
      case 4: launch_gather_runs<uint32_t, uint32_t>(table, idx, out, B, E, N, F, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (load_bytes) {
      case 8: launch_gather_runs<uint16_t, uint2>(table, idx, out, B, E, N, F, s); break;
      case 4: launch_gather_runs<uint16_t, uint32_t>(table, idx, out, B, E, N, F, s); break;
      case 2: launch_gather_runs<uint16_t, uint16_t>(table, idx, out, B, E, N, F, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// int32 entries of K3's workspace for B graphs of E ids into N rows:
// row_ptr [B, N+1], perm [B, E], n_long [B], long_rows [B, N], and, where the
// CSR build keeps its counts in global memory, its table [B, walkers, N].
int64_t k3_workspace_ints(int B, int E, int N) {
  const K3Plan p = k3_plan(B, E, N);
  return (int64_t)B * (N + 1) + (int64_t)B * E + B + (int64_t)B * N +
         (p.global_table ? (int64_t)B * p.warps * N : 0);
}

// ids [B, E] int32 in [0, N) in any order, ws of k3_workspace_ints(B, E, N)
// int32: writes the CSR (the first launch of k3_scatter_rows alone).
int k3_scatter_csr(const void* ids, void* ws, int B, int E, int N, void* stream) {
  return k3_launch_csr(ids, ws, B, E, N, static_cast<cudaStream_t>(stream));
}

// K3's kernels for B graphs of E ids into N rows of F columns: 0 the narrow
// kernel (rows of at most K3_NARROW_F columns of a graph that one block
// holds), 1 scatter_small_kernel (a graph whose rows and CSR fit one block),
// 2 scatter_csr_kernel then scatter_sum_kernel (the rest).
int k3_route(int B, int E, int N, int F) {
  if (F >= 1 && F <= K3_NARROW_F && narrow_fits(narrow_plan(B, E, N, F, true), E)) return 0;
  return k3_small_bytes(E, N, F) != 0 ? 1 : 2;
}

// rows [B, E, F] f32 (rows_bf16 == 0) or bf16 (rows_bf16 != 0), ids [B, E]
// int32 in [0, N) in any order, ws as k3_scatter_csr's, out [B, N, F] f32.
// All contiguous. One launch on the narrow kernel and where a graph fits a
// block's shared memory, else two: the CSR build, then the row sums.
int k3_scatter_rows(const void* rows, const void* ids, void* ws, void* out, int B, int E, int N,
                    int F, int rows_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = k3_route(B, E, N, F);
  if (route == 0) {
    return rows_bf16
               ? k3_narrow_width<__nv_bfloat16, K3_NARROW_F>(rows, ids, out, B, E, N, F, s)
               : k3_narrow_width<float, K3_NARROW_F>(rows, ids, out, B, E, N, F, s);
  }
  if (route == 1) {
    const size_t small = k3_small_bytes(E, N, F);
    return rows_bf16 ? k3_launch_small<__nv_bfloat16>(rows, ids, out, B, E, N, F, small, s)
                     : k3_launch_small<float>(rows, ids, out, B, E, N, F, small, s);
  }
  const int err = k3_launch_csr(ids, ws, B, E, N, s);
  if (err != 0) return err;
  return rows_bf16 ? k3_launch_sum<__nv_bfloat16>(rows, ws, out, B, E, N, F, s)
                   : k3_launch_sum<float>(rows, ws, out, B, E, N, F, s);
}

// table [B, N, row_bytes] (any 2- or 4-byte element type), idx [B, E] int32
// in [0, N), out [B, E, row_bytes]; row_bytes <= K7_WINDOW_BYTES. vec_bytes as K2's.
int k7_gather_windowed(const void* table, const void* idx, void* out, int B, int E, int N,
                       int row_bytes, int vec_bytes, void* stream) {
  if (row_bytes > K7_WINDOW_BYTES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_gather_windowed<uint4>(table, idx, out, B, E, N, row_bytes, s); break;
    case 8: launch_gather_windowed<uint2>(table, idx, out, B, E, N, row_bytes, s); break;
    case 4: launch_gather_windowed<uint32_t>(table, idx, out, B, E, N, row_bytes, s); break;
    case 2: launch_gather_windowed<uint16_t>(table, idx, out, B, E, N, row_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// msgs [B, E, F] f32 (masked already), dst [B, E] int32 sorted per graph,
// out [B, N, F] f32. All contiguous.
int k8_segment_sum_2d(const void* msgs, const void* dst, void* out, int B, int E, int N, int F,
                      void* stream) {
  return walk_launch<float, false>(msgs, dst, nullptr, out, B, E, N, F,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"

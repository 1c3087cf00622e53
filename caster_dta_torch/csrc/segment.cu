// Segment kernels of the GNN message passing, for Hopper (sm_90a).
//
// K1  segment_sum_sorted: out[b, n, :] = sum of msgs[b, e, :] over the real
//     edges e (mask[b, e] != 0) whose destination dst[b, e] == n. The edges of
//     each graph are sorted by dst (padding edges carry dst = N-1 and are
//     masked), so the edges of one destination row are one contiguous range.
//     Replaces the Pallas kernel caster_dta_tpu/ops/pallas_segment.py
//     ::_segment_kernel_t (one-hot MXU matmuls per destination-row block).
//     On this card the sum is bound by memory bytes: it does one add per
//     message element read. Design: one block per (graph, tile of K1_ROWS
//     destination rows). The block finds each row's edge range by binary
//     search over the graph's sorted dst (the role of _block_ptr), then every
//     thread owns (row, feature) outputs and sums that row's masked edges in
//     f32, in edge order, in a register, and writes the output once.
//     Deterministic, no atomics; a row with no edges comes out 0.
//
// K2  gather_rows: out[b, e, :] = table[b, idx[b, e], :] for any index order.
//     Replaces the Pallas kernel caster_dta_tpu/ops/pallas_segment.py
//     ::_onehot_gather_kernel (one-hot MXU matmul against the node table).
//     Bound by memory bytes: a pure copy. Design: each thread copies one
//     vector of a row (16, 8, 4 or 2 bytes, the widest that divides the row
//     bytes), so neighbouring threads read neighbouring addresses of a row.
//     An exact copy, bit for bit.
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
//     an empty row comes out 0. A graph whose rows (as f32), ids and CSR fit
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
//     (16, 8, 4 or 2 bytes a thread, as K2). Sorted indices (dst) span a few
//     rows a chunk and read each table row about once; unsorted ones span the
//     table and read it whole per chunk. Not dispatched on any path, as in the
//     JAX package, which measured it and kept the resident-table gather.
//
// K8  segment_sum_2d: out[b, n, :] = sum of msgs[b, e, :] over every edge e
//     (no mask: the messages are already masked) whose dst[b, e] == n; dst
//     sorted within each graph; f32 only. The row-major form of K1. Replaces
//     the Pallas kernel caster_dta_tpu/ops/pallas_segment.py::_segment_kernel
//     (one-hot MXU products over the edge chunks of a block of node rows, its
//     edge range from a block-pointer table). Bound by memory bytes. Design,
//     unlike K1's thread-per-output walk: one block per (graph, tile of
//     K8_ROWS node rows, tile of K8_COLS features). The block finds its rows'
//     edge ranges by binary search on the sorted dst, streams its edges in
//     chunks of K8_CHUNK whose message columns it stages in shared memory
//     with coalesced reads, and each thread adds its (row, column) entries'
//     staged values, in edge order, into a shared f32 tile that is written
//     once. A warp owns one row of the tile, so its lanes walk the same edges.
//     Deterministic, no atomics; an empty row comes out 0, and the sums equal
//     K1's bit for bit on the same masked rows (a masked row adds +0).
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

constexpr int K1_ROWS = 32;      // destination rows per block
constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 256;
constexpr int K2_MAX_BLOCKS = 132 * 32;  // grid-stride beyond this
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
constexpr int K8_ROWS = 8;       // node rows per block, one warp each
constexpr int K8_COLS = 32;      // features per block, one lane each
constexpr int K8_THREADS = K8_ROWS * K8_COLS;
constexpr int K8_CHUNK = 224;    // edges staged per pass (28 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// First position in dst[0, E) whose value is >= key (dst sorted ascending).
__device__ __forceinline__ int lower_bound(const int* __restrict__ dst, int E, int key) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dst[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
segment_sum_sorted_kernel(const T* __restrict__ msgs, const int* __restrict__ dst,
                          const uint8_t* __restrict__ mask, float* __restrict__ out,
                          int E, int N, int F) {
  __shared__ int row_ptr[K1_ROWS + 1];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * K1_ROWS;
  const int* dst_b = dst + (int64_t)b * E;
  if (threadIdx.x <= K1_ROWS) row_ptr[threadIdx.x] = lower_bound(dst_b, E, n0 + (int)threadIdx.x);
  __syncthreads();

  const int rows = min(K1_ROWS, N - n0);
  const T* msgs_b = msgs + (int64_t)b * E * F;
  const uint8_t* mask_b = mask + (int64_t)b * E;
  float* out_b = out + ((int64_t)b * N + n0) * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F;
    const int f = i - r * F;
    float acc = 0.f;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      if (mask_b[e]) acc += to_f32(msgs_b[(int64_t)e * F + f]);
    }
    out_b[(int64_t)r * F + f] = acc;
  }
}

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

__global__ void __launch_bounds__(K8_THREADS)
segment_sum_2d_kernel(const float* __restrict__ msgs, const int* __restrict__ dst,
                      float* __restrict__ out, int E, int N, int F) {
  __shared__ int row_ptr[K8_ROWS + 1];
  __shared__ float stage[K8_CHUNK * K8_COLS];
  __shared__ float tile[K8_ROWS * K8_COLS];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * K8_ROWS;
  const int c0 = blockIdx.z * K8_COLS;
  const int n_rows = min(K8_ROWS, N - n0);
  const int n_cols = min(K8_COLS, F - c0);
  const int* dst_b = dst + (int64_t)b * E;
  if (threadIdx.x <= n_rows) row_ptr[threadIdx.x] = lower_bound(dst_b, E, n0 + (int)threadIdx.x);
  // thread (row r, column c) owns tile[r][c]: a warp is one row
  const int r = threadIdx.x / K8_COLS;
  const int c = threadIdx.x % K8_COLS;
  tile[threadIdx.x] = 0.f;
  __syncthreads();

  const int lo = row_ptr[0], hi = row_ptr[n_rows];
  const float* msgs_b = msgs + (int64_t)b * E * F + c0;
  for (int e0 = lo; e0 < hi; e0 += K8_CHUNK) {
    const int n_e = min(K8_CHUNK, hi - e0);
    for (int i = threadIdx.x; i < n_e * n_cols; i += K8_THREADS) {
      const int e = i / n_cols;
      const int col = i - e * n_cols;
      stage[e * K8_COLS + col] = msgs_b[(int64_t)(e0 + e) * F + col];
    }
    __syncthreads();
    if (r < n_rows && c < n_cols) {
      const int from = max(row_ptr[r], e0) - e0;
      const int to = min(row_ptr[r + 1], e0 + n_e) - e0;
      float acc = tile[threadIdx.x];
      for (int e = from; e < to; ++e) acc += stage[e * K8_COLS + c];
      tile[threadIdx.x] = acc;
    }
    __syncthreads();  // the next chunk overwrites the stage
  }
  if (r < n_rows && c < n_cols) out[((int64_t)b * N + n0 + r) * F + c0 + c] = tile[threadIdx.x];
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

}  // namespace

extern "C" {

// msgs [B, E, F] f32 (msgs_bf16 == 0) or bf16 (msgs_bf16 != 0), dst [B, E]
// int32 sorted per graph, mask [B, E] bool, out [B, N, F] f32. All contiguous.
int k1_segment_sum_sorted(const void* msgs, const void* dst, const void* mask, void* out,
                          int B, int E, int N, int F, int msgs_bf16, void* stream) {
  const dim3 grid((N + K1_ROWS - 1) / K1_ROWS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (msgs_bf16) {
    segment_sum_sorted_kernel<__nv_bfloat16><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(msgs), static_cast<const int*>(dst),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out), E, N, F);
  } else {
    segment_sum_sorted_kernel<float><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const float*>(msgs), static_cast<const int*>(dst),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out), E, N, F);
  }
  return (int)cudaGetLastError();
}

// table [B, N, row_bytes] (any 2- or 4-byte element type), idx [B, E] int32
// in [0, N), out [B, E, row_bytes]. vec_bytes (16, 8, 4 or 2) divides row_bytes and the
// alignment of both pointers.
int k2_gather_rows(const void* table, const void* idx, void* out, int B, int E, int N,
                   int row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_gather<uint4>(table, idx, out, B, E, N, row_bytes, s); break;
    case 8: launch_gather<uint2>(table, idx, out, B, E, N, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(table, idx, out, B, E, N, row_bytes, s); break;
    case 2: launch_gather<uint16_t>(table, idx, out, B, E, N, row_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
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

// rows [B, E, F] f32 (rows_bf16 == 0) or bf16 (rows_bf16 != 0), ids [B, E]
// int32 in [0, N) in any order, ws as k3_scatter_csr's, out [B, N, F] f32.
// All contiguous. One launch where a graph fits a block's shared memory, else
// two: the CSR build, then the row sums.
int k3_scatter_rows(const void* rows, const void* ids, void* ws, void* out, int B, int E, int N,
                    int F, int rows_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t small = k3_small_bytes(E, N, F);
  if (small != 0) {
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
  const dim3 grid((N + K8_ROWS - 1) / K8_ROWS, B, (F + K8_COLS - 1) / K8_COLS);
  segment_sum_2d_kernel<<<grid, K8_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msgs), static_cast<const int*>(dst), static_cast<float*>(out),
      E, N, F);
  return (int)cudaGetLastError();
}

}  // extern "C"

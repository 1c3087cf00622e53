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
//     is bound by memory bytes, as K1's is. Design: one block per (graph,
//     tile of K3_ROWS node rows, tile of K3_COLS features). The block streams
//     the graph's ids in chunks of K3_THREADS; per chunk it compacts, in edge
//     order (warp ballot and popc), the edges whose id falls in its row tile
//     into shared memory, and all threads stage those edges' values (widened
//     to f32) in shared memory together. K3_GROUPS threads own each row's
//     features; they add their row's staged values into f32 registers, in
//     edge order, and write each output once. Deterministic, no atomics; an
//     empty row comes out 0. The ids are re-read once per row tile (from L2).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int K1_ROWS = 32;      // destination rows per block
constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 256;
constexpr int K2_MAX_BLOCKS = 132 * 32;  // grid-stride beyond this
constexpr int K3_ROWS = 32;      // node rows per block
constexpr int K3_GROUPS = 8;     // threads per node row
constexpr int K3_THREADS = K3_ROWS * K3_GROUPS;  // 256, also the edge chunk
constexpr int K3_COLS = 32;      // features per block (32 KB of f32 stage)
constexpr int K3_PER_THREAD = K3_COLS / K3_GROUPS;
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

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
scatter_rows_kernel(const T* __restrict__ rows, const int* __restrict__ ids,
                    float* __restrict__ out, int E, int N, int F) {
  __shared__ int warp_count[K3_THREADS / 32];
  __shared__ int list_e[K3_THREADS];
  __shared__ int list_r[K3_THREADS];
  __shared__ float stage[K3_THREADS * K3_COLS];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * K3_ROWS;
  const int c0 = blockIdx.z * K3_COLS;
  const int n_rows = min(K3_ROWS, N - n0);
  const int n_cols = min(K3_COLS, F - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // K3_GROUPS threads per row; thread g of a row owns its columns g, g + K3_GROUPS, ...
  const int my_row = threadIdx.x / K3_GROUPS;
  const int group = threadIdx.x % K3_GROUPS;
  const int* ids_b = ids + (int64_t)b * E;
  const T* rows_b = rows + (int64_t)b * E * F + c0;

  float acc[K3_PER_THREAD];
#pragma unroll
  for (int q = 0; q < K3_PER_THREAD; ++q) acc[q] = 0.f;

  int id_next = (int)threadIdx.x < E ? ids_b[threadIdx.x] : 0;
  for (int e0 = 0; e0 < E; e0 += K3_THREADS) {
    const int e = e0 + threadIdx.x;
    const int id = id_next;
    if (e + K3_THREADS < E) id_next = ids_b[e + K3_THREADS];  // the next chunk's, early
    bool hit = false;
    int r = 0;
    if (e < E) {
      // an id outside [0, N) stops the kernel, as the plain version raises
      if (id < 0 || id >= N) __trap();
      r = id - n0;
      hit = r >= 0 && r < n_rows;
    }
    // compact the chunk's edges of this row tile, in edge order
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < K3_THREADS / 32; ++w) {
      const int c = warp_count[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      list_e[slot] = e;
      list_r[slot] = r;
    }
    __syncthreads();
    // stage the listed edges' values of this column tile, widened to f32:
    // every thread loads, so a row with many edges costs one pass, not one
    // memory round trip per edge
    const int n_vals = total * n_cols;
#pragma unroll 4
    for (int i = threadIdx.x; i < n_vals; i += K3_THREADS) {
      const int j = i / n_cols;
      const int c = i - j * n_cols;
      stage[j * K3_COLS + c] = to_f32(rows_b[(int64_t)list_e[j] * F + c]);
    }
    __syncthreads();
    // each thread adds its row's staged values in edge order
    for (int j = 0; j < total; ++j) {
      if (list_r[j] == my_row) {
#pragma unroll
        for (int q = 0; q < K3_PER_THREAD; ++q) {
          const int col = group + q * K3_GROUPS;
          if (col < n_cols) acc[q] += stage[j * K3_COLS + col];
        }
      }
    }
    __syncthreads();  // the lists and the stage are rewritten by the next chunk
  }

  if (my_row < n_rows) {
    float* out_r = out + ((int64_t)b * N + n0 + my_row) * F + c0;
#pragma unroll
    for (int q = 0; q < K3_PER_THREAD; ++q) {
      const int col = group + q * K3_GROUPS;
      if (col < n_cols) out_r[col] = acc[q];
    }
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

// rows [B, E, F] f32 (rows_bf16 == 0) or bf16 (rows_bf16 != 0), ids [B, E]
// int32 in [0, N) in any order, out [B, N, F] f32. All contiguous.
int k3_scatter_rows(const void* rows, const void* ids, void* out, int B, int E, int N, int F,
                    int rows_bf16, void* stream) {
  const dim3 grid((N + K3_ROWS - 1) / K3_ROWS, B, (F + K3_COLS - 1) / K3_COLS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_bf16) {
    scatter_rows_kernel<__nv_bfloat16><<<grid, K3_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(ids),
        static_cast<float*>(out), E, N, F);
  } else {
    scatter_rows_kernel<float><<<grid, K3_THREADS, 0, s>>>(
        static_cast<const float*>(rows), static_cast<const int*>(ids),
        static_cast<float*>(out), E, N, F);
  }
  return (int)cudaGetLastError();
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

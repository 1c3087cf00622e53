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
// Plain C interface, loaded with ctypes (caster_dta_torch/ops/cuda_segment.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K1_ROWS = 32;      // destination rows per block
constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 256;
constexpr int K2_MAX_BLOCKS = 132 * 32;  // grid-stride beyond this

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

}  // extern "C"

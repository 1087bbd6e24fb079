// Intensity-gated 4-neighbour flood fill (plane region grow) for Hopper.
//
// Replaces graph_slam_tpu/planes/pallas_grow.py:_grow_kernel (launched by
// region_grow_pallas) in the batched (P, H, W) form that
// graph_slam_tpu/planes/propagation.py:_region_grow_batch computes:
//
//   mask_0     = seed & member
//   mask_{s+1} = (mask_s | (shiftL(mask_s) & sm_l) | (shiftR(mask_s) & sm_r)
//                        | (shiftU(mask_s) & sm_u) | (shiftD(mask_s) & sm_d))
//                & member
//
// for `steps` steps, with zero-filled shifts (nothing wraps across an edge).
// seed/member are (P, H, W) bytes, the four gates (H, W) bytes shared by all
// planes, the output (P, H, W) bytes holding 0/1 — bit-equal to the reference.
//
// What bounds it on this card: latency and occupancy, not bytes. Each step
// touches a few tens of KB per plane, but the steps are dependent, so the
// whole loop stays inside one launch: one thread block per plane keeps its
// mask bit-packed (32 pixels per word) in shared memory, double-buffered,
// with the packed member mask beside it (3 * H * ceil(W/32) words: 115.2 KB
// at 640x480, 10.4 KB at 176x144). No mask goes to device memory between
// steps. The gates are packed once per call by a small kernel into
// 4 * H * ceil(W/32) words in device memory and read through the read-only
// cache. Left/right shifts carry the edge bit across neighbouring words;
// padding bits beyond W are zero in member and gates and so stay zero.
// The loop exits early once a step changes nothing (__syncthreads_or); that
// is exact because the update is monotone.
//
// With P blocks on 132 SMs the card is mostly idle for small P. Making it
// fast (several blocks per plane through a thread-block cluster sharing the
// mask over distributed shared memory) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// One thread per output word: bits of row `row` of `src`, columns
// [32k, 32k + 32), bit b = column 32k + b; columns >= W read as 0.
__global__ void pack_rows_kernel(const uint8_t* __restrict__ src,
                                 uint32_t* __restrict__ dst, int rows, int W,
                                 int wpr) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * wpr) return;
  const int k = (int)(idx % wpr);
  const uint8_t* r = src + (idx / wpr) * (long long)W;
  uint32_t word = 0;
  const int x0 = 32 * k;
  const int n = min(32, W - x0);
  for (int b = 0; b < n; ++b) word |= (uint32_t)(r[x0 + b] != 0) << b;
  dst[idx] = word;
}

__global__ void __launch_bounds__(kThreads)
region_grow_kernel(const uint8_t* __restrict__ seed,
                   const uint8_t* __restrict__ member,
                   const uint32_t* __restrict__ gates,  // (4, H, wpr): l r u d
                   uint8_t* __restrict__ out, int H, int W, int wpr,
                   int steps) {
  extern __shared__ uint32_t smem[];
  const int nw = H * wpr;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + nw;
  uint32_t* mem = smem + 2 * nw;
  const long long plane = (long long)blockIdx.x * H * W;
  const uint8_t* sp = seed + plane;
  const uint8_t* mp = member + plane;

  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int y = i / wpr;
    const int x0 = 32 * (i - y * wpr);
    const int n = min(32, W - x0);
    const uint8_t* srow = sp + (long long)y * W + x0;
    const uint8_t* mrow = mp + (long long)y * W + x0;
    uint32_t s = 0, m = 0;
    for (int b = 0; b < n; ++b) {
      s |= (uint32_t)(srow[b] != 0) << b;
      m |= (uint32_t)(mrow[b] != 0) << b;
    }
    mem[i] = m;
    cur[i] = s & m;
  }
  __syncthreads();

  const uint32_t* gl = gates;
  const uint32_t* gr = gates + nw;
  const uint32_t* gu = gates + 2 * nw;
  const uint32_t* gd = gates + 3 * nw;
  for (int step = 0; step < steps; ++step) {
    int changed = 0;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      const int y = i / wpr;
      const int k = i - y * wpr;
      const uint32_t c = cur[i];
      // from the left neighbour (column x-1): bit b <- bit b-1
      uint32_t left = c << 1;
      if (k > 0) left |= cur[i - 1] >> 31;
      // from the right neighbour (column x+1): bit b <- bit b+1
      uint32_t right = c >> 1;
      if (k + 1 < wpr) right |= cur[i + 1] << 31;
      const uint32_t up = y > 0 ? cur[i - wpr] : 0u;        // row y-1
      const uint32_t down = y + 1 < H ? cur[i + wpr] : 0u;  // row y+1
      const uint32_t grown = (left & __ldg(gl + i)) | (right & __ldg(gr + i)) |
                             (up & __ldg(gu + i)) | (down & __ldg(gd + i));
      const uint32_t n = (c | grown) & mem[i];
      nxt[i] = n;
      changed |= (n != c);
    }
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    // barrier between this step's writes and the next step's reads
    if (!__syncthreads_or(changed)) break;
  }

  uint8_t* op = out + plane;
  for (int j = threadIdx.x; j < H * W; j += blockDim.x) {
    const int y = j / W;
    const int x = j - y * W;
    op[j] = (uint8_t)((cur[y * wpr + (x >> 5)] >> (x & 31)) & 1u);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for an (H, W) plane.
long long region_grow_smem_bytes(int H, int W) {
  return 3LL * H * ((W + 31) / 32) * (long long)sizeof(uint32_t);
}

// seed, member: (P, H, W) uint8; gates: (4, H, W) uint8 (l, r, u, d);
// gates_packed: scratch of 4 * H * ceil(W/32) uint32; out: (P, H, W) uint8.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int region_grow_launch(const void* seed, const void* member, const void* gates,
                       void* gates_packed, void* out, int P, int H, int W,
                       int steps, void* stream) {
  const int wpr = (W + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  const long long words = 4LL * H * wpr;
  pack_rows_kernel<<<(unsigned)((words + 255) / 256), 256, 0, s>>>(
      (const uint8_t*)gates, (uint32_t*)gates_packed, 4 * H, W, wpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long smem = region_grow_smem_bytes(H, W);
  err = cudaFuncSetAttribute(region_grow_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  region_grow_kernel<<<P, kThreads, (size_t)smem, s>>>(
      (const uint8_t*)seed, (const uint8_t*)member,
      (const uint32_t*)gates_packed, (uint8_t*)out, H, W, wpr, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

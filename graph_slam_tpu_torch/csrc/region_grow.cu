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
// What bounds it: on paper bytes (every input read once, the output written
// once: 2.15 MB for one 640x480 plane, well under a microsecond of the card's
// memory rate). In practice the `steps` passes depend on each other, so the
// floor is steps-that-ran barriers plus one launch, and the work around the
// loop (bytes to bits and back) has to be kept from costing more than the
// loop. The design, point by point:
//
// - A thread-block cluster per plane. The plane's rows are cut into C bands
//   (C = 1, 2, 4 or 8, the wrapper picks it from the shape), one per block of
//   the cluster, so C SMs load, step and store one plane. A block keeps only
//   its band, bit-packed 32 pixels to a word: the mask twice (read one, write
//   the other) and the four gates with member folded into them, all in
//   shared memory (6 * rows * ceil(W/32) words: 36.5 KB for 60 + 16 rows of
//   640). Shared memory was taken for the gates rather than registers: it
//   serves any band size with one code path. No mask and no gate is read
//   from device memory between steps.
// - Ghost rows through distributed shared memory, exchanged every K steps.
//   A cluster barrier costs several block barriers, so a block also holds K
//   ghost rows above and K below its band and steps them itself: step j
//   after an exchange computes all but the outer j rows at each end, which
//   is exact for the band through step K, with block barriers only. In the
//   last step before an exchange (the first step of all, then every K-th)
//   the thread that computes a word of the band's first or last K rows
//   also writes it into the neighbouring block's staging slot (a
//   remote store, off the critical path; nobody reads remotely). Then comes
//   the one cluster barrier of the K steps, and each block copies its slots
//   into its ghost rows. The slots are double-buffered by the parity of the
//   exchange: a slot written in exchange g was last read after the barrier
//   of exchange g-2, which its reader left before it reached barrier g-1.
// - The early exit is cluster-wide and exact. A warp in which any word of
//   changed in the step before an exchange writes the stamp g+1 into the
//   parity's flag word of every block of the cluster. After the barrier
//   every block reads its own flag: all see the same stamps, so all leave
//   together.
//   Leaving is exact because the update is monotone: a step that changes
//   nothing in the whole plane is a fixed point. That barrier is also the
//   last point at which a neighbour writes into a block's shared memory, so
//   a block never exits under a remote store.
// - Wide packed loads. Where W is a multiple of 16 and the tensors are
//   16-byte aligned, a thread loads 16 bytes (uint4) of each of the six
//   inputs, neighbouring threads neighbouring addresses, turns them into 16
//   bits without a loop over bytes (each byte is compared with 0 first: a
//   uint8 input may hold other values than 1), and two lanes are joined into
//   a word by one shuffle. The output goes the same way back, 16 bytes a
//   store. Other widths take a scalar path, a word a thread.
// - One launch, no scratch. Each block packs the gate rows of its own band;
//   the repeat over planes is cheaper than a second launch and comes from L2.
//
// Padding bits beyond W are zero in member, so they stay zero in the mask;
// left/right shifts carry the edge bit across neighbouring words of a row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kInputs = 6;  // seed, member, gate l, r, u, d

struct Inputs {
  const uint8_t* p[kInputs];
};

// The 4 bytes of x -> 4 bits, bit b set iff byte b is not 0.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t t = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (((t >> 7) * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ uint32_t nonzero16(const uint4 v) {
  return nonzero4(v.x) | (nonzero4(v.y) << 4) | (nonzero4(v.z) << 8) |
         (nonzero4(v.w) << 12);
}

// 4 bits -> 4 bytes of 0/1, byte b = bit b.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Barrier over all threads of the cluster (of the block where kCluster is
// false), ordering shared-memory writes, remote ones included, before it
// against reads after it.
template <bool kCluster>
__device__ __forceinline__ void sync_all() {
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// Bytes to bits for image rows [y_first, y_first + rows) of the six inputs,
// with y counted from y_first; rows outside [0, H) pack to 0. Member is
// folded into the others: dst[0][y * wpr + k] gets seed & member, dst[1..4]
// the gates l, r, u, d & member. `src` point at each input's row 0.
template <bool kWide>
__device__ __forceinline__ void pack_rows(const Inputs& src,
                                          uint32_t* const* dst, int y_first,
                                          int rows, int H, int W, int wpr) {
  const int tid = threadIdx.x;
  if constexpr (kWide) {
    // One 16-pixel chunk a thread; a packed row is 2 * wpr chunks, of which
    // the first W / 16 hold pixels. Even lanes hold the low half of a word.
    const int cpr = 2 * wpr;
    const int real = W >> 4;
    const int n = rows * cpr;
#pragma unroll 2
    for (int j0 = 0; j0 < n; j0 += blockDim.x) {  // same trip count block-wide
      const int j = j0 + tid;
      const int y = j / cpr;
      const int c = j - y * cpr;
      const bool live =
          j < n && c < real && (unsigned)(y_first + y) < (unsigned)H;
      const long long off = (long long)(y_first + y) * W + 16 * c;
      uint32_t b[kInputs];
#pragma unroll
      for (int q = 0; q < kInputs; ++q) {
        b[q] = 0;
        if (live)
          b[q] = nonzero16(__ldg(reinterpret_cast<const uint4*>(src.p[q] + off)));
      }
#pragma unroll
      for (int q = 0; q < kInputs; ++q) {
        if (q == 1) continue;
        const uint32_t lo = b[q] & b[1];
        const uint32_t hi = __shfl_xor_sync(0xffffffffu, lo, 1);
        if (!(tid & 1) && j < n) dst[q ? q - 1 : 0][j >> 1] = lo | (hi << 16);
      }
    }
  } else {
    for (int i = tid; i < rows * wpr; i += blockDim.x) {
      const int y = i / wpr;
      const int x0 = 32 * (i - y * wpr);
      const int n =
          (unsigned)(y_first + y) < (unsigned)H ? min(32, W - x0) : 0;
      const long long off = (long long)(y_first + y) * W + x0;
      uint32_t b[kInputs] = {0, 0, 0, 0, 0, 0};
      for (int t = 0; t < n; ++t) {
#pragma unroll
        for (int q = 0; q < kInputs; ++q)
          b[q] |= (uint32_t)(src.p[q][off + t] != 0) << t;
      }
      dst[0][i] = b[0] & b[1];
#pragma unroll
      for (int q = 2; q < kInputs; ++q) dst[q - 1][i] = b[q] & b[1];
    }
  }
}

// Bits of `rows` packed rows back to bytes of 0/1.
template <bool kWide>
__device__ __forceinline__ void unpack_rows(const uint32_t* bits, uint8_t* out,
                                            int rows, int W, int wpr) {
  const int tid = threadIdx.x;
  if constexpr (kWide) {
    const int real = W >> 4;
    const int n = rows * real;
    for (int j = tid; j < n; j += blockDim.x) {
      const int y = j / real;
      const int c = j - y * real;
      const uint32_t h = bits[y * wpr + (c >> 1)] >> (16 * (c & 1));
      uint4 v;
      v.x = spread4(h);
      v.y = spread4(h >> 4);
      v.z = spread4(h >> 8);
      v.w = spread4(h >> 12);
      *reinterpret_cast<uint4*>(out + (long long)y * W + 16 * c) = v;
    }
  } else {
    for (int j = tid; j < rows * W; j += blockDim.x) {
      const int y = j / W;
      const int x = j - y * W;
      out[j] = (uint8_t)((bits[y * wpr + (x >> 5)] >> (x & 31)) & 1u);
    }
  }
}

// Grid P * C blocks, clusters of C along x: cluster p works on plane p, its
// block of rank r on rows [r0, r0 + rows) = [r * band, min(H, (r + 1) * band)),
// band = ceil(H / C); a band may be short or empty. K is the number of steps
// between two exchanges: K <= rows of every band that is not empty.
// blockDim.x >= ceil(W / 32).
//
// A block holds E = band + 2K rows: K ghost rows above its band, the band, K
// ghost rows below; local row ly is image row r0 - K + ly, and rows outside
// the image are 0 in member, so they stay 0 in the mask. Member is folded
// into the gates when they are packed: the mask starts inside member, and a
// bit that may only come in through gates & member stays inside it.
// Shared memory (words), the same layout in every block of the cluster:
//   cur, nxt, gate l, r, u, d & member : E * wpr each
//   stage[parity][top, bottom]        : K * wpr each
//   flag[parity]                      : 1 each
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
region_grow_kernel(const Inputs in, uint8_t* __restrict__ out, int H, int W,
                   int steps, int K, int wide) {
  extern __shared__ uint32_t smem[];
  int C = 1, rank = 0;
  if constexpr (kCluster) {
    C = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int tid = threadIdx.x;
  const int plane = blockIdx.x / C;
  const int wpr = (W + 31) >> 5;
  const int band = (H + C - 1) / C;
  const int r0 = min(rank * band, H);
  const int rows = min(band, H - r0);
  const int E = band + 2 * K;
  const int nw = E * wpr;
  // local rows a step may compute: the band and its ghost rows, less one
  // row at each end for every step since the last exchange
  const int live_rows = rows > 0 ? rows + 2 * K : 0;

  uint32_t* cur = smem;
  uint32_t* nxt = smem + nw;
  uint32_t* dst[kInputs - 1] = {cur, smem + 2 * nw, smem + 3 * nw,
                                smem + 4 * nw, smem + 5 * nw};
  const uint32_t* gl = dst[1];
  const uint32_t* gr = dst[2];
  const uint32_t* gu = dst[3];
  const uint32_t* gd = dst[4];
  uint32_t* stage = smem + 6 * nw;
  uint32_t* flag = stage + 4 * K * wpr;

  // a flag of 0 is no stamp; rows of nxt that no step writes read as 0
  if (tid < 2) flag[tid] = 0;
  for (int i = tid; i < nw; i += blockDim.x) nxt[i] = 0;

  // the ghost rows come from device memory like the band: what the
  // neighbours hold at step 0 is seed & member too
  const long long plane_off = (long long)plane * H * W;
  Inputs src = in;
  src.p[0] += plane_off;
  src.p[1] += plane_off;
  if (wide)
    pack_rows<true>(src, dst, r0 - K, E, H, W, wpr);
  else
    pack_rows<false>(src, dst, r0 - K, E, H, W, wpr);

  // every block of the cluster runs from here on, so its shared memory may
  // be written
  sync_all<kCluster>();

  // where the band's first K and last K rows go before an exchange: the
  // bottom slots of the block above, the top slots of the block below
  const bool has_up = kCluster && rows > 0 && rank > 0;
  const bool has_down = kCluster && rows > 0 && r0 + rows < H;
  uint32_t* up_stage = nullptr;
  uint32_t* down_stage = nullptr;
  if constexpr (kCluster) {
    if (has_up) up_stage = cg::this_cluster().map_shared_rank(stage, rank - 1);
    if (has_down)
      down_stage = cg::this_cluster().map_shared_rank(stage, rank + 1);
  }

  // thread -> column word k and rows y0, y0 + rstride, ... of a step's rows
  const int k = tid % wpr;
  const int y0 = tid / wpr;
  const int rstride = blockDim.x / wpr;
  const bool active = y0 < rstride;

  int done = 0;
  for (int group = 0; done < steps; ++group) {
    const int par = group & 1;
    // the first exchange comes after one step, so a seed that is already
    // the answer leaves at once; then every K steps
    const int kk = group == 0 ? 1 : min(K, steps - done);
    uint32_t* my_top = stage + 2 * par * K * wpr;
    uint32_t* my_bottom = my_top + K * wpr;
    bool changed = false;
    for (int j = 1; j <= kk; ++j) {
      const bool last = j == kk;
      if (active) {
        for (int y = j + y0; y < live_rows - j; y += rstride) {
          const int i = y * wpr + k;
          const uint32_t c = cur[i];
          // from the left neighbour (column x-1): bit b <- bit b-1
          uint32_t left = c << 1;
          if (k > 0) left |= cur[i - 1] >> 31;
          // from the right neighbour (column x+1): bit b <- bit b+1
          uint32_t right = c >> 1;
          if (k + 1 < wpr) right |= cur[i + 1] << 31;
          const uint32_t grown = (left & gl[i]) | (right & gr[i]) |
                                 (cur[i - wpr] & gu[i]) | (cur[i + wpr] & gd[i]);
          const uint32_t n = c | grown;
          nxt[i] = n;
          if (last) {
            changed |= (n != c);
            // the band is local rows [K, K + rows): its first K rows go up,
            // its last K rows down
            if (up_stage && y >= K && y < 2 * K)
              up_stage[(2 * par + 1) * K * wpr + (y - K) * wpr + k] = n;
            if (down_stage && y >= rows && y < K + rows)
              down_stage[2 * par * K * wpr + (y - rows) * wpr + k] = n;
          }
        }
      }
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
      if (!last) __syncthreads();
    }
    if (__any_sync(0xffffffffu, changed) && (tid & 31) == 0) {
      if constexpr (kCluster) {
        for (int q = 0; q < C; ++q)
          cg::this_cluster().map_shared_rank(flag, q)[par] = (uint32_t)group + 1;
      } else {
        flag[par] = (uint32_t)group + 1;
      }
    }
    // one cluster barrier for K steps: the words, forwarded rows and stamps
    // of this group are written before it, the next group reads after it
    sync_all<kCluster>();
    if (((volatile uint32_t*)flag)[par] != (uint32_t)group + 1) break;
    done += kk;
    if (kCluster && done < steps) {
      // the neighbours' rows, K steps on, into the ghost rows
      for (int i = tid; i < K * wpr; i += blockDim.x) {
        if (has_up) cur[i] = my_top[i];
        if (has_down) cur[(K + rows) * wpr + i] = my_bottom[i];
      }
      __syncthreads();
    }
  }

  const long long out_off = plane_off + (long long)r0 * W;
  if (wide)
    unpack_rows<true>(cur + K * wpr, out + out_off, rows, W, wpr);
  else
    unpack_rows<false>(cur + K * wpr, out + out_off, rows, W, wpr);
}

// Block size, shared memory and cluster size of a launch, and the kernel's
// leave to use that much shared memory.
cudaError_t configure(int C, int threads, long long smem,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (C == 1)
    return cudaFuncSetAttribute(region_grow_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaFuncSetAttribute(region_grow_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of a cluster of C needs for an (H, W) plane
// with K steps between exchanges.
long long region_grow_smem_bytes(int H, int W, int C, int K) {
  const long long wpr = (W + 31) / 32;
  const long long band = (H + C - 1) / C;
  return (6 * (band + 2 * K) * wpr + 4 * K * wpr + 2) *
         (long long)sizeof(uint32_t);
}

// How many clusters of C blocks of `threads` threads the current device can
// run at once for an (H, W) plane (blocks on one SM where C is 1); 0 where
// such a cluster cannot be scheduled, -cudaError where the question fails.
int region_grow_max_active_clusters(int H, int W, int C, int K, int threads) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const long long smem = region_grow_smem_bytes(H, W, C, K);
  cudaError_t err = configure(C, threads, smem, &cfg, &attr);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  cfg.gridDim = dim3((unsigned)C);
  int n = 0;
  if (C == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, region_grow_kernel<false>, threads, (size_t)smem);
  else
    err = cudaOccupancyMaxActiveClusters(&n, region_grow_kernel<true>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// seed, member, out: (P, H, W) uint8; gate_l, gate_r, gate_u, gate_d: (H, W)
// uint8. One launch of P clusters of C blocks of `threads` threads on
// `stream`, K steps between exchanges (at most the rows of the shortest band
// that is not empty); does not synchronise; returns cudaGetLastError().
int region_grow_launch(const void* seed, const void* member, const void* gate_l,
                       const void* gate_r, const void* gate_u,
                       const void* gate_d, void* out, int P, int H, int W,
                       int steps, int C, int K, int threads, void* stream) {
  Inputs in;
  in.p[0] = (const uint8_t*)seed;
  in.p[1] = (const uint8_t*)member;
  in.p[2] = (const uint8_t*)gate_l;
  in.p[3] = (const uint8_t*)gate_r;
  in.p[4] = (const uint8_t*)gate_u;
  in.p[5] = (const uint8_t*)gate_d;
  uintptr_t low = (uintptr_t)out;
  for (int q = 0; q < kInputs; ++q) low |= (uintptr_t)in.p[q];
  const int wide = (W % 16 == 0) && (low % 16 == 0);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = configure(C, threads, region_grow_smem_bytes(H, W, C, K),
                              &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3((unsigned)P * (unsigned)C);
  cfg.stream = (cudaStream_t)stream;
  if (C == 1)
    err = cudaLaunchKernelEx(&cfg, region_grow_kernel<false>, in,
                             (uint8_t*)out, H, W, steps, K, wide);
  else
    err = cudaLaunchKernelEx(&cfg, region_grow_kernel<true>, in, (uint8_t*)out,
                             H, W, steps, K, wide);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

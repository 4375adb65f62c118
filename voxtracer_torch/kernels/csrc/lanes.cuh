// Lane fetching for the persistent ray kernels K1 (fog_march.cu), K2
// (svo_cast.cu), K4 (hf_cast.cu), K8 (bit_dda.cu) and K9's walk stages
// (path_trace.cu).
//
// A kernel that uses it launches one card's worth of blocks (SMs x the
// blocks one SM holds, from the occupancy calculator), and its warps share
// out the lanes: most are dealt round robin, 32 at a time, the rest are
// claimed in chunks from one global counter, which the wrapper allocates
// as a zeroed int32. Of every 32 lanes it scans, a warp writes the outputs
// of the inactive ones itself, coalesced, and queues the active ones in
// its own ring in shared memory. A thread whose ray is done takes the next
// queued ray once at least `refill` threads of its warp are idle (Aila &
// Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
// 2009: the persistent while-while loop with dynamic fetch). So a warp
// walks only active rays, and a warp whose short rays finish refills
// instead of idling behind its longest ray. Which thread runs which ray
// changes, and when; no ray's own arithmetic does.

#pragma once

#include <cuda_runtime.h>

namespace voxt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kQueue = 64;  // queued lanes per warp: < 32 before a scan,
                            // at most 32 more after it

struct LaneArgs {
  int* counter;        // next unclaimed dynamic lane; 0 at launch
  const bool* active;  // lane mask, or nullptr for all lanes
  int n;               // lanes
  int per_warp;        // lanes each warp scans before it claims, x32
  int chunk;           // lanes per claim from the counter, x32
  int refill;          // idle threads of a warp that trigger a refill
  // a queue whose length an earlier kernel wrote on the card: the lane
  // count is read there at launch and `static_pct` percent of it is
  // dealt out (n and per_warp unused); nullptr: n and per_warp as given
  const int* count = nullptr;
  int static_pct = 0;
};

// The lane split of a persistent launch of `warps` warps: the lanes dealt
// to each warp (`static_pct` percent of all, 32 at a time).
__host__ __device__ inline int lanes_per_warp(int n, long long warps,
                                              int static_pct) {
  return (int)((long long)n * static_pct / 100 / warps) & ~31;
}

// Calls ray.flush() where the whole warp meets, if Ray has one: a ray may
// leave there what it appends to a queue, a warp's lanes at once.
template <class Ray>
__device__ __forceinline__ auto flush_warp(Ray& ray, int)
    -> decltype(ray.flush(), void()) {
  ray.flush();
}
template <class Ray>
__device__ __forceinline__ void flush_warp(Ray&, long) {}

// Runs every lane of `a` through `ray`, one warp at a time; all 32
// threads of the warp call it together. The first `per_warp` x warps
// lanes are dealt out without atomics, 32 at a time and round robin
// (warp w scans lanes 32w.., then 32(w + warps).., ...), so all warps move
// through the lanes together, front to back, as one ordinary launch
// would; the rest are claimed `chunk` lanes at a time from the counter,
// so the load evens out at the end while the single counter sees few
// claims. `queue` is the warp's kQueue ints of shared memory. Threads
// run up to kSteps steps between two looks at the warp's idle threads.
// Ray provides (thread-local state, no warp intrinsics inside start and
// step):
//   skip(base, lanes): write the outputs of lanes base + j for every bit
//       j of `lanes` (all 32 threads call it, for coalesced stores);
//   start(i): set up lane i; true while its ray walks, else it has
//       written its outputs;
//   step(): one loop step; false once the ray has written its outputs;
//   flush() (optional): called by all 32 threads once before each look
//       and before returning; a thread finishes at most one ray between
//       two calls.
// With kStats, lane 0's ray.lane_steps and ray.warp_steps (unsigned) add
// the steps the warp's threads took and the steps the warp ran (its
// longest thread's), so lane_steps / (32 warp_steps) is the walk's SIMT
// efficiency.
template <int kSteps, bool kStats = false, class Ray>
__device__ __forceinline__ void run_lanes(const LaneArgs& a, int* queue,
                                          Ray& ray) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int n = a.count != nullptr ? *a.count : a.n;
  const int per_warp = a.count != nullptr
                           ? lanes_per_warp(n, warps, a.static_pct)
                           : a.per_warp;
  const int first_claimed = warps * per_warp;
  if (a.count != nullptr && n == 0) return;  // an empty queue
  // warp-uniform: the next 32 lanes to scan at cur, the end of the
  // lanes dealt or claimed and the stride through them, the queue, and
  // whether the counter may have lanes left
  int cur = 32 * warp, end = first_claimed, stride = 32 * warps;
  int head = 0, queued = 0;
  bool more = true;
  bool busy = false;
  while (true) {
    flush_warp(ray, 0);
    const unsigned idle = __ballot_sync(kFullMask, !busy);
    const int n_idle = __popc(idle);
    if (idle == kFullMask || (n_idle >= a.refill && (more || queued > 0))) {
      while (more && queued < n_idle) {
        if (cur >= end) {
          int base = 0;
          // on a queue whose length an earlier kernel wrote, a plain read
          // first: once the claims have passed its end, the warps that
          // find it so make no atomic (the count only grows)
          if (lane == 0)
            base = a.count != nullptr &&
                           *(volatile int*)a.counter >= n - first_claimed
                       ? n
                       : first_claimed + atomicAdd(a.counter, a.chunk);
          base = __shfl_sync(kFullMask, base, 0);
          if (base >= n) {
            more = false;
            break;
          }
          cur = base;
          end = min(base + a.chunk, n);
          stride = 32;
        }
        const int i = cur + lane;
        const bool valid = i < end;
        const bool act = valid && (a.active == nullptr || a.active[i]);
        const unsigned am = __ballot_sync(kFullMask, act);
        const unsigned skipped = __ballot_sync(kFullMask, valid) & ~am;
        if (skipped != 0u) ray.skip(cur, skipped);
        if (act) queue[(head + queued + __popc(am & below)) & (kQueue - 1)] = i;
        queued += __popc(am);
        cur += stride;
      }
      __syncwarp();
      if (!busy) {
        const int r = __popc(idle & below);
        if (r < queued) busy = ray.start(queue[(head + r) & (kQueue - 1)]);
      }
      const int taken = min(n_idle, queued);
      head += taken;
      queued -= taken;
      __syncwarp();
      if (!more && queued == 0 && __ballot_sync(kFullMask, busy) == 0u) {
        flush_warp(ray, 0);
        return;
      }
    }
    if constexpr (kStats) {
      unsigned k = 0;
      if (busy) {
#pragma unroll 1
        while (k < kSteps) {
          ++k;
          busy = ray.step();
          if (!busy) break;
        }
      }
      const unsigned lane_steps = __reduce_add_sync(kFullMask, k);
      const unsigned warp_steps = __reduce_max_sync(kFullMask, k);
      if (lane == 0) {
        ray.lane_steps += lane_steps;
        ray.warp_steps += warp_steps;
      }
    } else if (busy) {
#pragma unroll 1
      for (int k = 0; k < kSteps; ++k) {
        busy = ray.step();
        if (!busy) break;
      }
    }
  }
}

// Whether the lane-fetch settings are ones run_lanes handles.
inline bool valid_fetch(int static_pct, int chunk, int refill) {
  return static_pct >= 0 && static_pct <= 100 && chunk >= 32 &&
         chunk % 32 == 0 && refill >= 1;
}

// The same for a launch of `blocks` x `threads`.
inline int lanes_per_warp(int n, int blocks, int threads, int static_pct) {
  return lanes_per_warp(n, (long long)blocks * (threads / 32), static_pct);
}

// Blocks of a persistent launch on the current device: as many as the SMs
// hold at once, but no more than the lanes fill.
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads,
                                     size_t dyn_smem, int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dyn_smem);
  if (err != cudaSuccess) return err;
  const int need = (n + threads - 1) / threads;
  const int full = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = need < full ? need : full;
  return cudaSuccess;
}

}  // namespace voxt

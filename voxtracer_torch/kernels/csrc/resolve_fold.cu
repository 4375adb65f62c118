// K3: the rasterizer's resolve fold.
//
// Replaces: voxtracer/kernels/pallas/resolve.py, resolve_fold /
// _resolve_kernel (the Pallas TPU kernel), and the XLA scan it stands in
// for (voxtracer/kernels/raster.py, resolve_scan and the near pre-pass).
// Same results, bit for bit, as resolve_fold_plain and
// resolve_fold_seg_plain in voxtracer_torch/kernels/resolve.py and as
// raster._mirrored_slab; built with --fmad=false.
//
// What it computes: per raster tile, fold K candidate boxes into every
// ray's best-hit carry (t, pl = owner << 2 | entry axis, rgb). Each
// candidate gets the traversal's mirrored slab test; the fold is
// candidate-sequential with a strict <, so the first candidate seen wins
// a tie. Candidates are sorted-pair records [key, owner, q0, q1, q2, r, g,
// b] (int32 x 8: 16-bit coordinate and extent fields, rgb as float bits).
// Two forms share one kernel:
// - explicit lists: records (N, K, 8) beside a validity mask (N, K), or
//   one list (K, 8) shared by every tile (tile stride 0, the near
//   pre-pass); the folded carry goes to new arrays;
// - segment form: the sorted pair array itself, a list of tiles, each
//   tile's first record and one count K; reads clamp at the last record
//   and a record is valid when its key >> db is the tile. The full-frame
//   carry is updated in place for the listed tiles, and each listed tile
//   gets the max of t over its real pixels and the distance bound of the
//   first record it has not folded (inf past its segment's end): what a
//   widen round needs to tell whether the tile is complete.
//
// What bounds it on the card: at K = 16 (the main fold) the 52 bytes a
// ray moves; at K >= 64 (widen rounds, near list) the instruction rate.
// The slab test's subtractions and multiplies must each round alone, so
// none fuses into a multiply-add, and its min/max, compares and selects
// run at half the multiply rate.
//
// Design.
// - The unit of work is a warp: (tile, chunk of 32 * RT rays, span of
//   candidates). A thread holds RT rays (1/|d|, bound, winner index) in
//   registers, and every staged candidate value it loads is used for all
//   of them.
// - The warp stages 32 candidates at a time in its own shared memory,
//   one a lane, as the six numerators (mlo - s0, mhi - s0) of the
//   mirrored slab test, which depend on the candidate and the ray's sign
//   octant only. When every ray of the warp lies in one octant (nearly
//   every tile) a candidate is staged for that octant, 2 x 16 bytes that
//   serve all RT rays; else it is staged for both signs of every axis
//   and each ray picks its pairs by address. Either way the inner loop
//   is six multiplies, three min/max (three-input, on the floats' bits:
//   see slab) and two compares a pair, with no subtraction and no select
//   of planes: the carry's t and the far cap fold into
//   one running bound, an invalid record stages as +inf and so never
//   hits, and the winner's entry axis, owner and rgb are decoded from its
//   record once, after the loop.
// - Loads are sent together and early, so a warp waits on device
//   memory once before the fold and once after: a lane fetches its record
//   of the first stage, then all its rays' directions and carries, before
//   any is used (read-only arrays through __ldg, which may pass stores),
//   and the record of the next stage before it folds the current one;
//   the winners' records are fetched together before the first is
//   decoded. The explicit form holds the carry it read and writes every
//   ray once; the segment form, in place, writes only rays that found a
//   nearer hit.
// - Warps synchronise only with themselves (__syncwarp); a block is 4
//   warps, which for the main fold are one tile of 512 rays or 4 tiles of
//   64, so no prologue is shared and no block-wide barrier is taken.
// - A long list over few tiles is cut into up to 16 spans, one warp
//   each inside one block, until the grid holds two waves of warps. The
//   spans' results (t, index) meet in shared memory and merge in list
//   order with the same strict <, so the first candidate still wins a
//   tie.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kStage = 32;       // candidates a warp stages: one a lane
constexpr int kSlotOne = 8;      // floats of a candidate staged for one octant
constexpr int kSlotAll = 12;     // ... staged for both signs of every axis
constexpr int kWarpSmem = kStage * kSlotAll;  // floats of one warp's stage
constexpr int kBlockWarps = 4;   // warps a block holds (more with 8, 16 spans)
constexpr int kMaxSpans = 16;
constexpr int kMinSpan = 32;     // fewest candidates worth a span
constexpr int kWaves = 2;        // waves of warps the spans aim at
constexpr unsigned kFull = 0xFFFFFFFFu;

struct FoldArgs {
  // the carry by tile; in and out are the same arrays in the segment form
  const float* t_in;
  const int* pl_in;
  const float* rgb_in;
  float* t_out;
  int* pl_out;
  float* rgb_out;
  const float* dir;  // (tiles, rays, 3)
  const int* rows;   // records, 8 ints each
  // explicit lists: the mask, and the records from one slot's list to the
  // next (0: one list for every slot)
  const unsigned char* valid;  // one byte a record, 0 or 1
  long long tile_stride;
  // segment form: the listed tiles (null: slot == tile), each slot's
  // first record, the last record's index, the key bits below the tile
  const int* tiles;
  const int* start;
  int last;
  int db;
  const unsigned char* ok;  // (tiles, rays) real pixels as bytes, or null
  float* tile_max;  // (slots,) preset to -inf, or null
  // segment form: (slots,) the bound of the slot's next record, and the
  // length one step of a key's quantized distance stands for
  float* next_dmin;
  float quantum;
  float cam[3];
  float bound;
  float distance;
  int n_slots, rays, k;
  int chunks, spans, span_len, upb;
};

// Record c of a slot's list.
__device__ __forceinline__ const int* record(const FoldArgs& a, int slot,
                                             int c) {
  long long p;
  if (a.start != nullptr) {
    p = (long long)__ldg(a.start + slot) + c;
    if (p > a.last) p = a.last;
  } else {
    p = (long long)slot * a.tile_stride + c;
  }
  return a.rows + p * 8;
}

// What a lane fetches of its candidate ahead of staging it.
struct Raw {
  int q0, q1, q2;
  bool valid;
};

__device__ __forceinline__ Raw fetch(const FoldArgs& a, int slot, int tile,
                                     int c, int c_end) {
  Raw raw = {0, 0, 0, false};
  if (c < c_end) {
    const int* rec = record(a, slot, c);
    const int4 head = __ldg(reinterpret_cast<const int4*>(rec));
    raw.q0 = head.z;
    raw.q1 = head.w;
    raw.q2 = __ldg(rec + 4);
    raw.valid = a.start != nullptr
                    ? (head.x >> a.db) == tile
                    : __ldg(a.valid + (long long)slot * a.tile_stride + c) != 0;
  }
  return raw;
}

__device__ __forceinline__ void box(int q0, int q1, int q2, float lo[3],
                                    float hi[3]) {
  const unsigned u0 = (unsigned)q0, u1 = (unsigned)q1, u2 = (unsigned)q2;
  lo[0] = (float)(u0 & 0xFFFFu);
  lo[1] = (float)(u0 >> 16);
  lo[2] = (float)(u1 & 0xFFFFu);
  hi[0] = lo[0] + (float)(u1 >> 16);
  hi[1] = lo[1] + (float)(u2 & 0xFFFFu);
  hi[2] = lo[2] + (float)(u2 >> 16);
}

// The numerators of the mirrored slab test on one axis for one sign of
// the ray: e = mlo - s0 (entry), x = mhi - s0 (exit).
__device__ __forceinline__ void numerators(const FoldArgs& a, int ax,
                                           bool flip, float lo, float hi,
                                           float* e, float* x) {
  const float mlo = flip ? a.bound - hi : lo;
  const float mhi = flip ? a.bound - lo : hi;
  const float s0 = flip ? a.bound - a.cam[ax] : a.cam[ax];
  *e = mlo - s0;
  *x = mhi - s0;
}

// One slab test: the candidate's numerators against a ray's 1/|d|, its
// running bound l and winner jb. The min and max run on the floats' bits
// as integers, three at a time (Hopper's DPX min3/max3): floats above zero
// order as their bits do and above every float that is not, and the test
// passes only when the largest entry is above zero and below the smallest
// exit, so whenever it can pass, the integer min and max are the float
// ones; when it cannot, both say no.
__device__ __forceinline__ void slab(float e0, float e1, float e2, float x0,
                                     float x1, float x2, const float inv[3],
                                     int c, float* l, int* jb) {
  const int m = __vimax3_s32(__float_as_int(e0 * inv[0]),
                             __float_as_int(e1 * inv[1]),
                             __float_as_int(e2 * inv[2]));
  const int x = min(__vimin3_s32(__float_as_int(x0 * inv[0]),
                                 __float_as_int(x1 * inv[1]),
                                 __float_as_int(x2 * inv[2])),
                    __float_as_int(*l));
  if (m > 0 && m < x) {
    *l = __int_as_float(m);
    *jb = c;
  }
}

// IN_PLACE: the carry is updated where it lies (the segment form) and a
// ray that finds nothing nearer touches none of it; else the carry is
// read whole at the start, held, and written once to the output arrays.
template <int RT, bool IN_PLACE>
__global__ void __launch_bounds__(kMaxSpans * 32, 1)
resolve_fold_kernel(const FoldArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int span = warp % a.spans;
  const long long unit = (long long)blockIdx.x * a.upb + warp / a.spans;
  const bool live = unit < (long long)a.n_slots * a.chunks;
  float* stage = smem + warp * kWarpSmem;

  int slot = 0, tile = 0, r0 = 0;
  float inv[RT][3], lim[RT];
  int jb[RT];
  // the carry as read, held only when it goes to other arrays
  float tb[RT], cb[RT][3];
  int pb[RT];
  unsigned octs = 0;
  if (live) {
    slot = (int)(unit / a.chunks);
    tile = a.tiles != nullptr ? __ldg(a.tiles + slot) : slot;
    const int c_end = min(a.k, (span + 1) * a.span_len);
    int c0 = span * a.span_len;
    // every load of the prologue is sent before the first is used
    Raw raw = fetch(a, slot, tile, c0 + lane, c_end);
    // the thread's rays are r0 + 32 q; the last chunk may be ragged, and
    // a ray past the tile's end repeats the last one and stores nothing
    r0 = (int)(unit % a.chunks) * 32 * RT + lane;
    float d[RT][3], t0[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const long long i =
          (long long)tile * a.rays + min(r0 + 32 * q, a.rays - 1);
      for (int ax = 0; ax < 3; ++ax) d[q][ax] = __ldg(a.dir + 3 * i + ax);
      t0[q] = a.t_in[i];
      if (!IN_PLACE && span == 0) {
        tb[q] = t0[q];
        pb[q] = a.pl_in[i];
        for (int c = 0; c < 3; ++c) cb[q][c] = a.rgb_in[3 * i + c];
      }
    }
    unsigned present = 0;
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      unsigned oct = 0;
      for (int ax = 0; ax < 3; ++ax) {
        oct |= (d[q][ax] < 0.0f ? 1u : 0u) << ax;
        inv[q][ax] = 1.0f / fmaxf(fabsf(d[q][ax]), kEps);
      }
      octs |= oct << (3 * q);
      present |= 1u << oct;
      // one bound for "nearer than the carry" and "inside the far cap"
      lim[q] = fminf(a.distance, t0[q]);
      jb[q] = -1;
    }
    for (int s = 16; s > 0; s >>= 1)
      present |= __shfl_xor_sync(kFull, present, s);
    const bool one_octant = (present & (present - 1)) == 0;

    for (; c0 < c_end; c0 += kStage) {
      const int ncp = (min(kStage, c_end - c0) + 3) & ~3;
      __syncwarp();
      if (lane < ncp) {
        // past the span's end and invalid records stage as +inf: no hit
        float e[2][3], x[2][3];
        for (int ax = 0; ax < 3; ++ax)
          e[0][ax] = e[1][ax] = x[0][ax] = x[1][ax] = INFINITY;
        if (raw.valid) {
          float lo[3], hi[3];
          box(raw.q0, raw.q1, raw.q2, lo, hi);
          for (int ax = 0; ax < 3; ++ax) {
            if (one_octant) {
              numerators(a, ax, (octs >> ax) & 1u, lo[ax], hi[ax], &e[0][ax],
                         &x[0][ax]);
            } else {
              numerators(a, ax, false, lo[ax], hi[ax], &e[0][ax], &x[0][ax]);
              numerators(a, ax, true, lo[ax], hi[ax], &e[1][ax], &x[1][ax]);
            }
          }
        }
        if (one_octant) {
          float4* dst = reinterpret_cast<float4*>(stage + lane * kSlotOne);
          dst[0] = make_float4(e[0][0], e[0][1], e[0][2], x[0][0]);
          dst[1] = make_float4(x[0][1], x[0][2], 0.0f, 0.0f);
        } else {
          float4* dst = reinterpret_cast<float4*>(stage + lane * kSlotAll);
          for (int ax = 0; ax < 3; ++ax)
            dst[ax] = make_float4(e[0][ax], x[0][ax], e[1][ax], x[1][ax]);
        }
      }
      raw = fetch(a, slot, tile, c0 + kStage + lane, c_end);
      __syncwarp();

      if (one_octant) {
#pragma unroll 4
        for (int j = 0; j < ncp; ++j) {
          const float4* src =
              reinterpret_cast<const float4*>(stage + j * kSlotOne);
          const float4 p = src[0];
          const float4 s = src[1];
#pragma unroll
          for (int q = 0; q < RT; ++q)
            slab(p.x, p.y, p.z, p.w, s.x, s.y, inv[q], c0 + j, &lim[q],
                 &jb[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          // the ray's (e, x) pair of each axis: 4 floats an axis, the
          // flipped pair second
          const unsigned oct = (octs >> (3 * q)) & 7u;
          const float2* px =
              reinterpret_cast<const float2*>(stage) + (oct & 1u);
          const float2* py =
              reinterpret_cast<const float2*>(stage) + 2 + ((oct >> 1) & 1u);
          const float2* pz =
              reinterpret_cast<const float2*>(stage) + 4 + ((oct >> 2) & 1u);
#pragma unroll 4
          for (int j = 0; j < ncp; ++j) {
            const float2 vx = px[j * (kSlotAll / 2)];
            const float2 vy = py[j * (kSlotAll / 2)];
            const float2 vz = pz[j * (kSlotAll / 2)];
            slab(vx.x, vy.x, vz.x, vx.y, vy.y, vz.y, inv[q], c0 + j, &lim[q],
                 &jb[q]);
          }
        }
      }
    }
  }

  if (a.spans > 1) {
    // every span leaves (t, index) per ray in its own stage; span 0 of
    // the unit merges them in list order
    __syncwarp();
    if (live) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        stage[2 * (q * 32 + lane)] = lim[q];
        stage[2 * (q * 32 + lane) + 1] = __int_as_float(jb[q]);
      }
    }
    __syncthreads();
    if (span != 0) return;
    if (live) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        // every span began at the carry's bound, which span 0 kept if it
        // found nothing nearer
        for (int s = 1; s < a.spans; ++s) {
          const float* res = stage + s * kWarpSmem + 2 * (q * 32 + lane);
          const int js = __float_as_int(res[1]);
          if (js >= 0 && res[0] < lim[q]) {
            lim[q] = res[0];
            jb[q] = js;
          }
        }
      }
    }
  }
  if (!live) return;

  // the winners' records (owner, box, rgb), all fetched before any is used
  int4 head[RT], tail[RT];
  bool okq[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const bool real = r0 + 32 * q < a.rays;
    if (real && jb[q] >= 0) {
      const int4* rec = reinterpret_cast<const int4*>(record(a, slot, jb[q]));
      head[q] = __ldg(rec);
      tail[q] = __ldg(rec + 1);
    }
    okq[q] = real && a.tile_max != nullptr &&
             __ldg(a.ok + (long long)tile * a.rays + r0 + 32 * q) != 0;
  }
  float vmax = -INFINITY;
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    if (r0 + 32 * q >= a.rays) continue;
    const long long i = (long long)tile * a.rays + r0 + 32 * q;
    float t = 0.0f;
    if (jb[q] >= 0) {
      // its entry axis, x > y > z on ties
      t = lim[q];
      const unsigned oct = (octs >> (3 * q)) & 7u;
      float lo[3], hi[3], e[3], x;
      box(head[q].z, head[q].w, tail[q].x, lo, hi);
      for (int ax = 0; ax < 3; ++ax)
        numerators(a, ax, (oct >> ax) & 1u, lo[ax], hi[ax], &e[ax], &x);
      const int axis = e[0] * inv[q][0] == t ? 0
                       : (e[1] * inv[q][1] == t ? 1 : 2);
      a.t_out[i] = t;
      a.pl_out[i] = (head[q].y << 2) + axis;
      a.rgb_out[3 * i] = __int_as_float(tail[q].y);
      a.rgb_out[3 * i + 1] = __int_as_float(tail[q].z);
      a.rgb_out[3 * i + 2] = __int_as_float(tail[q].w);
    } else if (!IN_PLACE) {
      t = tb[q];
      a.t_out[i] = t;
      a.pl_out[i] = pb[q];
      for (int c = 0; c < 3; ++c) a.rgb_out[3 * i + c] = cb[q][c];
    } else if (okq[q]) {
      t = a.t_out[i];  // the carry's own
    }
    if (okq[q]) vmax = fmaxf(vmax, t);
  }
  if (a.tile_max != nullptr) {
    for (int s = 16; s > 0; s >>= 1)
      vmax = fmaxf(vmax, __int_as_float(__shfl_xor_sync(
                             kFull, __float_as_int(vmax), s)));
    // a float max as an integer one: floats of one sign order as their
    // bits do (reversed below zero), and the slot starts at -inf
    const int bits = __float_as_int(vmax);
    if (lane == 0 && vmax > -INFINITY) {
      if (bits >= 0)
        atomicMax(reinterpret_cast<int*>(a.tile_max + slot), bits);
      else
        atomicMin(reinterpret_cast<unsigned*>(a.tile_max + slot),
                  (unsigned)bits);
    }
  }
  if (IN_PLACE && a.next_dmin != nullptr && r0 == 0) {
    // the record after the k folded: a conservative lower bound of its
    // distance (the quantized floor less one step), or inf when the
    // tile's segment has ended
    const int key = __ldg(record(a, slot, a.k));
    const int q = max((key & ((1 << a.db) - 1)) - 1, 0);
    a.next_dmin[slot] =
        (key >> a.db) == tile ? (float)q * a.quantum : INFINITY;
  }
}

// Fill in the grid and launch. ray_tile: rays a thread holds (2 or 4; 0:
// 4 when the tile's rays are whole chunks of 128, else 2). spans: warps
// that share a list (1, 2, 4, 8 or 16; 0: as many as it takes to put
// kWaves waves of warps on the card, each span at least kMinSpan
// candidates).
int launch(FoldArgs a, int ray_tile, int spans, cudaStream_t stream) {
  if (a.n_slots <= 0 || a.rays <= 0 || a.k <= 0) return 0;
  if (ray_tile == 0) ray_tile = a.rays % 128 == 0 ? 4 : 2;
  if (ray_tile != 2 && ray_tile != 4) return (int)cudaErrorInvalidValue;
  void (*kernel)(const FoldArgs);
  if (a.t_out == a.t_in)
    kernel = ray_tile == 4 ? resolve_fold_kernel<4, true>
                           : resolve_fold_kernel<2, true>;
  else
    kernel = ray_tile == 4 ? resolve_fold_kernel<4, false>
                           : resolve_fold_kernel<2, false>;
  a.chunks = (a.rays + 32 * ray_tile - 1) / (32 * ray_tile);
  const long long units = (long long)a.n_slots * a.chunks;
  const size_t block_smem = (size_t)kBlockWarps * kWarpSmem * sizeof(float);
  if (spans == 0) {
    int dev = 0, sms = 0, blocks_per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, kernel, kBlockWarps * 32, block_smem);
    const long long want =
        (long long)kWaves * sms * blocks_per_sm * kBlockWarps;
    spans = 1;
    while (spans < kMaxSpans && units * spans < want &&
           a.k / (2 * spans) >= kMinSpan)
      spans *= 2;
  }
  if (spans < 1 || spans > kMaxSpans || (spans & (spans - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  a.spans = spans;
  a.span_len = (a.k + spans - 1) / spans;
  const int warps = spans > kBlockWarps ? spans : kBlockWarps;
  a.upb = warps / spans;
  const long long blocks = (units + a.upb - 1) / a.upb;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)warps * kWarpSmem * sizeof(float);
  kernel<<<(int)blocks, warps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Explicit lists: rows (n_tiles, k, 8) with valid (n_tiles, k) and
// tile_stride = k, or one list (k, 8) with valid (k,) and tile_stride 0.
extern "C" int voxt_resolve_fold(const void* t_in, const void* pl_in,
                                 const void* rgb_in, const void* rows,
                                 const void* valid, long long tile_stride,
                                 const void* dir, float cam_x, float cam_y,
                                 float cam_z, float bound, float distance,
                                 void* t_out, void* pl_out, void* rgb_out,
                                 int n_tiles, int rays, int k, int ray_tile,
                                 int spans, void* stream) {
  FoldArgs a = {};
  a.t_in = (const float*)t_in;
  a.pl_in = (const int*)pl_in;
  a.rgb_in = (const float*)rgb_in;
  a.t_out = (float*)t_out;
  a.pl_out = (int*)pl_out;
  a.rgb_out = (float*)rgb_out;
  a.dir = (const float*)dir;
  a.rows = (const int*)rows;
  a.valid = (const unsigned char*)valid;
  a.tile_stride = tile_stride;
  a.cam[0] = cam_x;
  a.cam[1] = cam_y;
  a.cam[2] = cam_z;
  a.bound = bound;
  a.distance = distance;
  a.n_slots = n_tiles;
  a.rays = rays;
  a.k = k;
  return launch(a, ray_tile, spans, (cudaStream_t)stream);
}

// Segment form: rows is the sorted pair array of n_records records; slot
// s folds the k records from start[s] on into tile tiles[s] (tiles null:
// tile s) of the carry (t, pl, rgb), in place, and leaves in tile_max[s]
// (preset to -inf) the max of t over the tile's rays marked in ok, and in
// next_dmin[s] the distance bound of record start[s] + k (its quantized
// distance less one step, times quantum; inf if it is another tile's).
extern "C" int voxt_resolve_fold_seg(void* t, void* pl, void* rgb,
                                     const void* rows, int n_records,
                                     const void* tiles, const void* start,
                                     int n_slots, int k, int db,
                                     float quantum, const void* dir,
                                     const void* ok, void* tile_max,
                                     void* next_dmin, float cam_x, float cam_y,
                                     float cam_z, float bound, float distance,
                                     int rays, int ray_tile, int spans,
                                     void* stream) {
  if (n_records <= 0) return (int)cudaErrorInvalidValue;
  FoldArgs a = {};
  a.t_in = a.t_out = (float*)t;
  a.pl_in = a.pl_out = (int*)pl;
  a.rgb_in = a.rgb_out = (float*)rgb;
  a.dir = (const float*)dir;
  a.rows = (const int*)rows;
  a.tiles = (const int*)tiles;
  a.start = (const int*)start;
  a.last = n_records - 1;
  a.db = db;
  a.ok = (const unsigned char*)ok;
  a.tile_max = (float*)tile_max;
  a.next_dmin = (float*)next_dmin;
  a.quantum = quantum;
  a.cam[0] = cam_x;
  a.cam[1] = cam_y;
  a.cam[2] = cam_z;
  a.bound = bound;
  a.distance = distance;
  a.n_slots = n_slots;
  a.rays = rays;
  a.k = k;
  return launch(a, ray_tile, spans, (cudaStream_t)stream);
}

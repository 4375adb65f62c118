// K6: the beam walk, a resumable interval-arithmetic octree walk that
// collects up to K candidate solid boxes per pixel tile.
//
// Replaces: voxtracer/kernels/beam.py, beam_walk (a jnp while_loop on the
// TPU, no Pallas kernel). Same results, bit for bit, as beam_walk_plain
// in voxtracer_torch/kernels/beam.py; built with --fmad=false.
//
// What it computes, per beam (a tile's origin and direction bounds, in
// the mirrored space where every direction interval is positive): each
// step pops an exhausted stack level or expands the pending child that
// comes first in near-to-far octant order. Expanding reads one 160-byte
// augmented row (children, their solid leaves, their colours) and
// slab-tests the 8 grandchild cells against the beam's bounds: solid ones
// that the beam overlaps (nearer than the cap) are emitted as candidates
// in rank order, interior ones become the next level's pending entries,
// and a solid cell every ray of the beam must pass through lowers the
// cap. A beam pauses once fewer than 8 candidate slots are free; its
// stacks, bit-words, cap and liveness stay in global memory, so the next
// call resumes it.
//
// What bounds it on the card: dependent row reads, one per step (the
// next row's address is in the previous row), and the longest beams of a
// warp, which set its time. The float work is ~100 ops a step.
//
// Design: eight lanes walk a beam, lane m owning mirrored octant m (a
// warp walks 4 beams, a block 16). A step is one ballot for the level's
// pending octants, one shuffle for the picked child's id, and then each
// lane reads its own child id, solid-leaf word and colour words of the
// row (neighbouring words: a step's reads fall in one or two sectors) and
// slab-tests its own cell with the plain walk's expressions. Two ballots
// give the group its emits and descents; an emitting lane writes its
// candidate at its rank in ORDER among the emitting lanes, so slots come
// out in the plain walk's order; the cap is a min over the group's
// covering lanes (a tree of shuffles). The pick, the bit-words and the
// pause test are the same in every lane of the group. Lane m keeps column
// m of the pending stack: ids and entries in shared memory for the whole
// call, the pending bits of all levels in one register; the levels still
// pending are read from the state once, and only the levels and scalars
// the call changed are written back. Values are never -0.0 (every
// entry is fmaxf(x, +0.0) of a product of a difference g - o with g >= +0
// and a positive inverse), so the shuffle trees' mins equal the plain
// walk's sequential ones by bits. Every lane of a warp runs the loop to
// the warp's last beam (collectives need all 32); a beam that ended,
// paused or was dead at the start only takes part in them. Dead beams do
// no step and write the plain version's outputs: lvl -1 in every slot, ok
// and t_safe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 8;  // a beam's lanes, one a mirrored octant
constexpr int kBeams = kThreads / kLanes;
constexpr int kLevels = 16;  // stack levels at the largest height, 15
constexpr unsigned kAll = 0xffffffffu;
constexpr float kFar = 1.0e12f;  // traverse.FAR
// near-to-far octant priority in mirrored space, (0, 1, 2, 4, 3, 5, 6, 7)
// packed a nibble a rank; it is its own inverse (it swaps 3 and 4), so
// order_at(m) is also the rank of octant m
__device__ __forceinline__ int order_at(int r) {
  return (0x76534210 >> (4 * r)) & 15;
}
// an octant mask in rank order: bits 3 and 4 swapped
__device__ __forceinline__ unsigned by_rank(unsigned mask) {
  return (mask & ~0x18u) | ((mask >> 1) & 0x8u) | ((mask << 1) & 0x10u);
}

struct WalkArgs {
  const int* aug;
  const float* olo;
  const float* ohi;
  const float* ilo;
  const float* ihi;
  const int* mirror;
  const bool* incoherent;
  int H, K, max_steps, skip_t0, n;
  int* h;
  int* ids_stk;
  int* mask_stk;
  float* entry_stk;
  int* words;
  float* cap;
  bool* alive;
  int* cand_lvl;
  int* cand_off;
  float* cand_rgb;
  bool* ok;
  float* t_safe;
};

__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    v = fminf(v, __int_as_float(__shfl_xor_sync(kAll, __float_as_int(v), off)));
  return v;
}

__global__ void __launch_bounds__(kThreads) beam_walk_kernel(const WalkArgs a) {
  __shared__ int s_ids[kLevels][kThreads];
  __shared__ float s_ent[kLevels][kThreads];
  const int tid = threadIdx.x;
  const int m = tid & (kLanes - 1);
  const int lead = tid & 31 & ~(kLanes - 1);  // the group's first lane
  const int b = blockIdx.x * kBeams + tid / kLanes;
  const bool valid = b < a.n;
  const int H = a.H, S = H + 1, K = a.K;

  float olo[3], ohi[3], ilo[3], ihi[3];
  int w[3];
  int h = 0, mirror = 0;
  float cap = kFar;
  bool alive = false;
  if (valid) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      olo[c] = a.olo[3 * b + c];
      ohi[c] = a.ohi[3 * b + c];
      ilo[c] = a.ilo[3 * b + c];
      ihi[c] = a.ihi[3 * b + c];
      w[c] = a.words[3 * b + c];
    }
    mirror = a.mirror[b];
    h = a.h[b];
    cap = a.cap[b];
    alive = a.alive[b];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      olo[c] = ohi[c] = ilo[c] = ihi[c] = 0.0f;
      w[c] = 0;
    }
  }
  const bool alive0 = alive;
  // the pending levels h..H of column m (the levels below h are empty
  // and are written before they are read)
  unsigned pend = 0u;
  if (alive) {
    for (int l = h; l <= H; ++l) {
      const int64_t at = ((int64_t)b * S + l) * 8 + m;
      s_ids[l][tid] = a.ids_stk[at];
      s_ent[l][tid] = a.entry_stk[at];
      pend |= (unsigned)((a.mask_stk[(int64_t)b * S + l] >> m) & 1) << l;
    }
  }
  int* clvl = a.cand_lvl + (int64_t)b * K;
  int* coff = a.cand_off + (int64_t)b * K * 3;
  float* crgb = a.cand_rgb + (int64_t)b * K * 3;

  int ncand = 0, steps = 0;
  unsigned dirty = 0u, mdirty = 0u;  // levels whose columns, masks changed
  bool run = alive && ncand <= K - 8 && steps < a.max_steps;
  while (__ballot_sync(kAll, run) != 0u) {
    const unsigned mask =
        (__ballot_sync(kAll, run && ((pend >> h) & 1u)) >> lead) & 0xffu;
    const bool expand = run && mask != 0u;
    if (run && mask == 0u) {  // pop
      h += 1;
      if (h > H) alive = false;
    }
    // the pending child first in ORDER
    const unsigned rm = by_rank(mask);
    const int j = order_at(__popc((rm & (0u - rm)) - 1u) & 7);
    const int child = __shfl_sync(kAll, expand ? s_ids[h][tid] : 0, lead + j);
    bool emit = false, desc = false, cover = false;
    float entry_lo = 0.0f, entry_hi = 0.0f;
    int gch = 0, hc = 1, gm = 0, g_off[3] = {0, 0, 0};
    const int* row = a.aug;
    if (expand) {
      if (m == j) pend &= ~(1u << h);
      mdirty |= 1u << h;
      hc = h < 1 ? 1 : (h > H ? H : h);
      if (h < H) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          w[c] = (w[c] & ~(1 << hc)) | (((j >> c) & 1) << hc);
      }
      row = a.aug + (int64_t)(child < 0 ? 0 : child) * 40;
      gm = m ^ mirror;  // this lane's world slot
      gch = __ldg(row + gm);
      const int gsl = __ldg(row + 8 + gm);
      const float s_g = (float)(1 << (hc - 1));
      const int low = (1 << hc) - 1;
      float elo = -3.0e38f, ehi = -3.0e38f, xlo = 3.0e38f, xhi = 3.0e38f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = (float)(w[c] & ~low) + (float)((m >> c) & 1) * s_g;
        g_off[c] = (int)g;
        const float ne_lo = g - ohi[c];
        const float ne_hi = g - olo[c];
        const float e_lo = fminf(ne_lo * ilo[c], ne_lo * ihi[c]);
        const float e_hi = fmaxf(ne_hi * ilo[c], ne_hi * ihi[c]);
        const float gx = g + s_g;
        const float nx_lo = gx - ohi[c];
        const float nx_hi = gx - olo[c];
        const float x_lo = fminf(nx_lo * ilo[c], nx_lo * ihi[c]);
        const float x_hi = fmaxf(nx_hi * ilo[c], nx_hi * ihi[c]);
        elo = fmaxf(elo, e_lo);
        ehi = fmaxf(ehi, e_hi);
        xlo = fminf(xlo, x_lo);
        xhi = fminf(xhi, x_hi);
      }
      entry_lo = fmaxf(elo, 0.0f);
      entry_hi = fmaxf(ehi, 0.0f);
      const bool overlap =
          (entry_lo <= xhi) && (xhi > 0.0f) && (entry_lo <= cap);
      const bool hit_cell = overlap && gch >= 0;
      emit = hit_cell && gsl >= 0;
      desc = hit_cell && gsl < 0;
      cover = emit && entry_hi < xlo && (!a.skip_t0 || entry_lo > 0.0f);
    }
    const unsigned eb = (__ballot_sync(kAll, emit) >> lead) & 0xffu;
    const unsigned db = (__ballot_sync(kAll, desc) >> lead) & 0xffu;
    const float cover_t = group_min(cover ? entry_hi : kFar);
    if (expand) {
      if (emit) {  // slot: rank among the emitting lanes
        const int k =
            ncand + __popc(by_rank(eb) & ((1u << order_at(m)) - 1u));
        const int size = 1 << (hc - 1);
        clvl[k] = hc - 1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          coff[3 * k + c] = ((mirror >> c) & 1) ? (1 << H) - g_off[c] - size
                                                : g_off[c];
          crgb[3 * k + c] = __int_as_float(__ldg(row + 16 + 3 * gm + c));
        }
      }
      ncand += __popc(eb);
      cap = fminf(cap, cover_t);
      if (db != 0u) {  // pending interior children one level down
        const int lv = hc - 1;
        s_ids[lv][tid] = gch;
        s_ent[lv][tid] = desc ? entry_lo : kFar;
        pend = (pend & ~(1u << lv)) | ((unsigned)desc << lv);
        dirty |= 1u << lv;
        mdirty |= 1u << lv;
        h = h - 1;
      }
    }
    if (run) ++steps;
    run = alive && ncand <= K - 8 && steps < a.max_steps;
  }

  if (valid) {  // unused slots, as the plain version leaves them
    for (int k = ncand + m; k < K; k += kLanes) clvl[k] = -1;
    for (int i = 3 * ncand + m; i < 3 * K; i += kLanes) {
      coff[i] = 0;
      crgb[i] = 0.0f;
    }
  }
  // write back the changed levels; the nearest pending entry
  float pmin = kFar;
  for (int l = 0; l < S; ++l) {
    const unsigned lm = (__ballot_sync(kAll, (pend >> l) & 1u) >> lead) & 0xffu;
    if ((pend >> l) & 1u) pmin = fminf(pmin, s_ent[l][tid]);
    if (valid && ((dirty >> l) & 1u)) {
      const int64_t at = ((int64_t)b * S + l) * 8 + m;
      a.ids_stk[at] = s_ids[l][tid];
      a.entry_stk[at] = s_ent[l][tid];
    }
    if (valid && m == 0 && ((mdirty >> l) & 1u))
      a.mask_stk[(int64_t)b * S + l] = (int)lm;
  }
  pmin = group_min(pmin);
  if (valid && m == 0) {
    if (alive0) {
      a.h[b] = h;
#pragma unroll
      for (int c = 0; c < 3; ++c) a.words[3 * b + c] = w[c];
      a.cap[b] = cap;
      a.alive[b] = alive;
    }
    const bool incoherent = a.incoherent[b];
    const bool done = !alive && !incoherent;
    a.ok[b] = done;
    a.t_safe[b] = incoherent ? 0.0f : (done ? kFar : pmin);
  }
}

}  // namespace

extern "C" int voxt_beam_walk(const void* aug, int height, const void* olo,
                              const void* ohi, const void* ilo,
                              const void* ihi, const void* mirror,
                              const void* incoherent, int K, int max_steps,
                              int skip_t0, void* h, void* ids_stk,
                              void* mask_stk, void* entry_stk, void* words,
                              void* cap, void* alive, void* cand_lvl,
                              void* cand_off, void* cand_rgb, void* ok,
                              void* t_safe, int n, void* stream) {
  if (n <= 0) return 0;
  if (height < 1 || height >= kLevels || K < 8)
    return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const int*)aug,      (const float*)olo,
                   (const float*)ohi,    (const float*)ilo,
                   (const float*)ihi,    (const int*)mirror,
                   (const bool*)incoherent,
                   height,               K,
                   max_steps,            skip_t0,
                   n,                    (int*)h,
                   (int*)ids_stk,        (int*)mask_stk,
                   (float*)entry_stk,    (int*)words,
                   (float*)cap,          (bool*)alive,
                   (int*)cand_lvl,       (int*)cand_off,
                   (float*)cand_rgb,     (bool*)ok,
                   (float*)t_safe};
  beam_walk_kernel<<<(n + kBeams - 1) / kBeams, kThreads, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

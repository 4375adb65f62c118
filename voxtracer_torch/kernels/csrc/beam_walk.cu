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
// next row's address is in the previous row), and divergence between
// beams that take different step counts. The float work is ~100 ops a
// step.
//
// Design (simple first): one thread walks one beam from start to pause,
// end or the step budget, with the current level's 8 ids and entries in
// registers only while it expands; the stacks are read and written in
// place. Candidates go straight to the output rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kFar = 1.0e12f;  // traverse.FAR
// near-to-far octant priority in mirrored space, (0, 1, 2, 4, 3, 5, 6, 7)
// packed a nibble a rank
__device__ __forceinline__ int order_at(int r) {
  return (0x76534210 >> (4 * r)) & 15;
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

__global__ void __launch_bounds__(kThreads) beam_walk_kernel(const WalkArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.n) return;
  const int H = a.H, S = H + 1, K = a.K;
  int* ids = a.ids_stk + (int64_t)b * S * 8;
  int* msk = a.mask_stk + (int64_t)b * S;
  float* ent = a.entry_stk + (int64_t)b * S * 8;
  int* clvl = a.cand_lvl + (int64_t)b * K;
  int* coff = a.cand_off + (int64_t)b * K * 3;
  float* crgb = a.cand_rgb + (int64_t)b * K * 3;
  for (int k = 0; k < K; ++k) {
    clvl[k] = -1;
    coff[3 * k] = coff[3 * k + 1] = coff[3 * k + 2] = 0;
    crgb[3 * k] = crgb[3 * k + 1] = crgb[3 * k + 2] = 0.0f;
  }
  float olo[3], ohi[3], ilo[3], ihi[3];
  int w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    olo[c] = a.olo[3 * b + c];
    ohi[c] = a.ohi[3 * b + c];
    ilo[c] = a.ilo[3 * b + c];
    ihi[c] = a.ihi[3 * b + c];
    w[c] = a.words[3 * b + c];
  }
  const int mirror = a.mirror[b];
  int h = a.h[b];
  float cap = a.cap[b];
  bool alive = a.alive[b];
  int ncand = 0;

  for (int step = 0; step < a.max_steps && alive; ++step) {
    if (ncand > K - 8) break;  // pause: the pending bit stays set
    const int mask = msk[h];
    if (mask == 0) {  // pop
      h += 1;
      if (h > H) alive = false;
      continue;
    }
    int j = 8;
#pragma unroll
    for (int r = 7; r >= 0; --r)
      if ((mask >> order_at(r)) & 1) j = order_at(r);
    msk[h] = mask & ~(1 << j);
    const int child = ids[h * 8 + j];
    const int hc = h < 1 ? 1 : (h > H ? H : h);
    if (h < H) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        w[c] = (w[c] & ~(1 << hc)) | (((j >> c) & 1) << hc);
    }
    const int* row = a.aug + (int64_t)(child < 0 ? 0 : child) * 40;
    const float s_g = (float)(1 << (hc - 1));
    const int low = (1 << hc) - 1;
    float cell_off[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cell_off[c] = (float)(w[c] & ~low);

    float entry_lo[8], entry_hi[8], exit_lo[8];
    int gch[8], gsl[8];
    bool emit[8], desc[8];
    const float cap0 = cap;
#pragma unroll
    for (int m = 0; m < 8; ++m) {  // mirrored slot m, world slot m ^ mirror
      const int gm = m ^ mirror;
      gch[m] = __ldg(row + gm);
      gsl[m] = __ldg(row + 8 + gm);
      float elo = -3.0e38f, ehi = -3.0e38f, xlo = 3.0e38f, xhi = 3.0e38f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = cell_off[c] + (float)((m >> c) & 1) * s_g;
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
      entry_lo[m] = fmaxf(elo, 0.0f);
      entry_hi[m] = fmaxf(ehi, 0.0f);
      exit_lo[m] = xlo;
      const bool overlap =
          (entry_lo[m] <= xhi) && (xhi > 0.0f) && (entry_lo[m] <= cap0);
      const bool hit_cell = overlap && gch[m] >= 0;
      emit[m] = hit_cell && gsl[m] >= 0;
      desc[m] = hit_cell && gsl[m] < 0;
    }

    // emit solid children in near-to-far rank order; lower the cap
    const int sflip = mirror;
    const int size = 1 << (hc - 1);
    float cover_t = kFar;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = order_at(r);
      if (!emit[m]) continue;
      const int k = ncand++;
      clvl[k] = hc - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int off_m =
            (int)(cell_off[c] + (float)((m >> c) & 1) * s_g);
        coff[3 * k + c] =
            ((sflip >> c) & 1) ? (1 << H) - off_m - size : off_m;
        crgb[3 * k + c] = __int_as_float(__ldg(row + 16 + 3 * (m ^ mirror) + c));
      }
      bool cover = entry_hi[m] < exit_lo[m];
      if (a.skip_t0) cover = cover && entry_lo[m] > 0.0f;
      if (cover) cover_t = fminf(cover_t, entry_hi[m]);
    }
    cap = fminf(cap, cover_t);

    // pending interior children one level down
    int dmask = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (desc[m]) dmask |= 1 << m;
    if (dmask != 0) {
      const int lv = hc - 1;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        ids[lv * 8 + m] = gch[m];
        ent[lv * 8 + m] = desc[m] ? entry_lo[m] : kFar;
      }
      msk[lv] = dmask;
      h = h - 1;
    }
  }

  a.h[b] = h;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.words[3 * b + c] = w[c];
  a.cap[b] = cap;
  a.alive[b] = alive;
  const bool incoherent = a.incoherent[b];
  const bool done = !alive && !incoherent;
  a.ok[b] = done;
  float pend = kFar;
  for (int l = 0; l < S; ++l) {
    const int mk = msk[l];
    for (int m = 0; m < 8; ++m)
      if ((mk >> m) & 1) pend = fminf(pend, ent[l * 8 + m]);
  }
  a.t_safe[b] = incoherent ? 0.0f : (done ? kFar : pend);
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
  if (height < 1 || height > 15 || K < 8) return (int)cudaErrorInvalidValue;
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
  beam_walk_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K4: the occupancy ray march (coarse block cull, fine step test) with its
// own ordered compaction.
//
// Replaces: cnc_tpu/render/marching.py march_rays (112-210), with
// ray_aabb_intersect (58-68) and occupancy_lookup (71-81) inlined, and the
// two compactions (scatter_ops.compact_mask_indices) between its passes.
// The dilated mip (build_march_mip, 84-101) stays plain torch: it is built
// once per chunk.  Plain twin: cnc_torch/render/marching.py `_march_plain`.
//
// cnc_tpu's structure fixes which samples come out, truncation included:
// the candidate (ray, block) pairs of the coarse test are cut to their first
// cap_c = max(256, capacity // 4) in (ray, block) order, and the hits of the
// kept blocks' fine tests to the first `capacity`.  Both cuts follow
// (ray, block, step) order, so one warp per ray can produce its own samples
// once it knows where its run of the buffer starts:
//   count: one warp per ray, lanes on its blocks of B steps: the coarse test
//          against the dilated mip (a ballot of candidate blocks), then for
//          each candidate block the B fine tests against the full grid (two
//          steps a lane in flight), the block's hits by
//          __popc of the ballots -> per ray the candidate and hit counts, per
//          (ray, block) the hits as a byte (0xff: no candidate), tmin / tmax,
//          and per group of 8 rays (one CUDA block) the totals;
//   scan:  one block of 1024 threads scans the groups' candidate totals to
//          find the ray that straddles cap_c (only a prefix of its candidate
//          blocks is kept, and only their hits count; only its group reads
//          its rays), then the kept hits, giving each group its first slot,
//          and writes truncated, resume_ray and the hit-count estimate with
//          the formulas of cnc_tpu's march;
//   write: one warp per ray adds its group's earlier rays to the group's
//          offsets, repeats the fine tests of its kept candidate blocks that
//          have hits and writes ray_id, t_mid and valid at its first slot
//          plus the ballot's rank, up to `capacity`, with the ray's
//          kept hit count and its last kept t_mid; then the grid fills the
//          padding slots as cnc_tpu's zero-filled compaction leaves them
//          (ray n_rays - 1, not valid, t_mid of the first candidate block's
//          first step, or of ray 0's step 0 when there is none).
//
// Exactness: this file is compiled with -fmad=false, so o + d*t and
// (pos-lo)/(hi-lo)*res are rounded after each operation as in the twin (an
// FMA moves them by an ulp and can flip a voxel).  All float constants
// (b*dt, dt, 1-1e-6, near, far) arrive already rounded to f32 by the wrapper,
// as JAX rounds its weak-typed Python scalars.  The tests are the same
// expressions in the same order as the twin's.
//
// Bound on the H100: bytes, and far under one launch.  It reads the rays
// (24 B each), the 4 KB mip and the 128^3 grid bytes it touches (at most
// 2 MB) and writes capacity * 9 B of samples; the tests cost a few dozen
// flops each.  At the view's 8,192 rays that is a few microseconds, so what
// costs is launches and their latency: three, on a workspace the wrapper
// keeps per (rays, blocks).  The scan reads per group, not per ray, so its
// one block stays short.

#include "common.cuh"

namespace {

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ aabb) {
  Box b;
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = aabb[a];
    b.hi[a] = aabb[3 + a];
  }
  return b;
}

// marching.ray_aabb_intersect + near/far/t_start clamps, then the training
// march's stratified near jitter tmin += u*dt (marching.py:143-144; u = 0 and
// has_jitter = false for the deterministic eval march).
__device__ __forceinline__ void ray_span(const float* __restrict__ o, const float* __restrict__ d,
                                         const Box& box, float near, float far, float t_start,
                                         bool has_start, float jitter, bool has_jitter, float dt,
                                         float* tmin, float* tmax) {
  float lo_t = 0.f, hi_t = 0.f;
  for (int a = 0; a < 3; ++a) {
    float da = d[a];
    if (fabsf(da) < 1e-10f) da = da >= 0.f ? 1e-10f : -1e-10f;
    const float inv = 1.0f / da;
    const float t0 = (box.lo[a] - o[a]) * inv;
    const float t1 = (box.hi[a] - o[a]) * inv;
    const float mn = fminf(t0, t1), mx = fmaxf(t0, t1);
    lo_t = a == 0 ? mn : fmaxf(lo_t, mn);
    hi_t = a == 0 ? mx : fminf(hi_t, mx);
  }
  lo_t = fmaxf(lo_t, near);
  hi_t = fminf(hi_t, far);
  if (has_start) lo_t = fmaxf(lo_t, t_start);
  if (has_jitter) lo_t = lo_t + jitter * dt;
  *tmin = lo_t;
  *tmax = hi_t;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned char NOT_CAND = 0xff;
constexpr int MARCH_WARPS = 8;        // rays per block of the count and write kernels
constexpr int SCAN_THREADS = 1024;

struct Ray {
  float o[3], d[3];
  float tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays_o,
                                        const float* __restrict__ rays_d, int r) {
  Ray ray;
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = rays_o[3ll * r + a];
    ray.d[a] = rays_d[3ll * r + a];
  }
  return ray;
}

// the coarse test of block `blk` (cnc_tpu: the block midpoint in the dilated
// mip, the block's start before tmax)
__device__ __forceinline__ bool coarse_test(const Ray& ray, const Box& box, int blk, float bdt,
                                            const unsigned char* __restrict__ mip, int mres,
                                            float clip_hi) {
  const float bi = static_cast<float>(blk);
  const float tc = ray.tmin + (bi + 0.5f) * bdt;
  int vox[3];
  for (int a = 0; a < 3; ++a) {
    const float p = ray.o[a] + ray.d[a] * tc;
    float x01 = (p - box.lo[a]) / (box.hi[a] - box.lo[a]);
    x01 = fminf(fmaxf(x01, 0.f), clip_hi);
    vox[a] = static_cast<int>(x01 * static_cast<float>(mres));
  }
  const bool occ = mip[(static_cast<long long>(vox[0]) * mres + vox[1]) * mres + vox[2]] != 0;
  const float blk_start = ray.tmin + bi * bdt;
  return occ && blk_start < ray.tmax;
}

// the fine test of step j of block `blk`; *tf gets the step's midpoint
__device__ __forceinline__ bool fine_test(const Ray& ray, const Box& box, int blk, int j, int b,
                                          int max_steps, float dt,
                                          const unsigned char* __restrict__ binaries, int res,
                                          float* tf_out) {
  const float step_f = static_cast<float>(blk) * static_cast<float>(b) + static_cast<float>(j);
  const float tf = ray.tmin + (step_f + 0.5f) * dt;
  *tf_out = tf;
  bool inside = true;
  int vox[3];
  for (int a = 0; a < 3; ++a) {
    const float p = ray.o[a] + ray.d[a] * tf;
    const float x01 = (p - box.lo[a]) / (box.hi[a] - box.lo[a]);
    inside &= x01 >= 0.f && x01 < 1.f;
    const int v = static_cast<int>(x01 * static_cast<float>(res));
    vox[a] = min(max(v, 0), res - 1);
  }
  bool occ = false;
  if (inside)
    occ = binaries[(static_cast<long long>(vox[0]) * res + vox[1]) * res + vox[2]] != 0;
  return occ && tf < ray.tmax && step_f < static_cast<float>(max_steps);
}

struct MarchArgs {
  const float* rays_o;
  const float* rays_d;
  const float* aabb;
  const float* t_start;            // [R] or null
  const unsigned char* ray_mask;   // [R] or null
  const float* jitter;             // [R] or null
  const unsigned char* mip;
  const unsigned char* binaries;
  int mres, res, n_rays, nb, b, max_steps, cap_c, capacity;
  float bdt, dt, near, far, clip_hi;
};

struct MarchWork {
  float* tmin;                     // [R]
  float* tmax;                     // [R]
  int* n_cand;                     // [R] candidate blocks
  int* n_hit;                      // [R] hits over all candidate blocks
  int* blk_cand;                   // [B] per group of MARCH_WARPS rays: candidates,
  int* blk_hit;                    //     hits,
  int* blk_first;                  //     its first candidate as ray * nb + block (-1: none),
  int* blk_coff;                   //     its first candidate's rank,
  int* blk_foff;                   //     its first slot
  int* meta;                       // [2] total_f, the padding's t_mid (bits)
  unsigned char* hits;             // [R, nb] hits per block, NOT_CAND where none
};

// The hits of one block's steps j0 + lane and j0 + 32 + lane, both tests in
// flight before either ballot.
__device__ __forceinline__ int block_hits(const Ray& ray, const Box& box, const MarchArgs& a,
                                          int blk, int j0, int lane) {
  float t;
  const int j1 = j0 + lane, j2 = j1 + 32;
  const bool h1 = j1 < a.b && fine_test(ray, box, blk, j1, a.b, a.max_steps, a.dt, a.binaries,
                                        a.res, &t);
  const bool h2 = j2 < a.b && fine_test(ray, box, blk, j2, a.b, a.max_steps, a.dt, a.binaries,
                                        a.res, &t);
  return __popc(__ballot_sync(FULL, h1)) + __popc(__ballot_sync(FULL, h2));
}

__global__ void __launch_bounds__(MARCH_WARPS * 32) march_count_kernel(MarchArgs a, MarchWork w) {
  __shared__ int s_nc[MARCH_WARPS], s_nh[MARCH_WARPS], s_first[MARCH_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * MARCH_WARPS + warp;
  int nc = 0, nh = 0, first = -1;
  if (r < a.n_rays) {
    const Box box = load_box(a.aabb);
    Ray ray = load_ray(a.rays_o, a.rays_d, r);
    ray_span(ray.o, ray.d, box, a.near, a.far, a.t_start ? a.t_start[r] : 0.f,
             a.t_start != nullptr, a.jitter ? a.jitter[r] : 0.f, a.jitter != nullptr, a.dt,
             &ray.tmin, &ray.tmax);
    const bool hit = ray.tmin < ray.tmax && (a.ray_mask == nullptr || a.ray_mask[r]);
    if (lane == 0) {
      w.tmin[r] = ray.tmin;
      w.tmax[r] = ray.tmax;
    }
    for (int base = 0; base < a.nb; base += 32) {
      const int blk = base + lane;
      const bool cand = hit && blk < a.nb &&
                        coarse_test(ray, box, blk, a.bdt, a.mip, a.mres, a.clip_hi);
      unsigned cm = __ballot_sync(FULL, cand);
      if (first < 0 && cm) first = r * a.nb + base + __ffs(cm) - 1;
      nc += __popc(cm);
      int mine = 0;
      while (cm) {
        const int bit = __ffs(cm) - 1;
        cm &= cm - 1;
        int count = 0;
        for (int j0 = 0; j0 < a.b; j0 += 64) count += block_hits(ray, box, a, base + bit, j0, lane);
        if (lane == bit) mine = count;
        nh += count;
      }
      if (blk < a.nb)
        w.hits[static_cast<long long>(r) * a.nb + blk] =
            cand ? static_cast<unsigned char>(mine) : NOT_CAND;
    }
    if (lane == 0) {
      w.n_cand[r] = nc;
      w.n_hit[r] = nh;
    }
  }
  if (lane == 0) {
    s_nc[warp] = nc;
    s_nh[warp] = nh;
    s_first[warp] = first;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0, h = 0, f = -1;
    for (int i = 0; i < MARCH_WARPS; ++i) {
      c += s_nc[i];
      h += s_nh[i];
      if (f < 0) f = s_first[i];
    }
    w.blk_cand[blockIdx.x] = c;
    w.blk_hit[blockIdx.x] = h;
    w.blk_first[blockIdx.x] = f;
  }
}

__device__ __forceinline__ int scan_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = warp_sums[lane];     // SCAN_THREADS / 32 == 32 warps
    int xi = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, xi, o);
      if (lane >= o) xi += t;
    }
    __syncwarp();
    warp_sums[lane] = xi - x;
    if (lane == 31) *total = xi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + inc - v;
  __syncthreads();
  return out;
}

// The hits that count of ray r whose first candidate block has rank c: all
// of them below the candidate budget, those of its first cap_c - c blocks
// across it, none above it.
__device__ int kept_hits(const MarchArgs& a, const MarchWork& w, int r, int c) {
  const int nc = w.n_cand[r];
  if (c + nc <= a.cap_c) return w.n_hit[r];
  if (c >= a.cap_c) return 0;
  const unsigned char* hb = w.hits + static_cast<long long>(r) * a.nb;
  int h = 0;
  for (int blk = 0, seen = 0; seen < a.cap_c - c; ++blk) {
    if (hb[blk] != NOT_CAND) {
      h += hb[blk];
      ++seen;
    }
  }
  return h;
}

// One block of SCAN_THREADS threads scans the ray groups' totals: each
// group's first candidate's rank and first slot, with the candidate budget
// applied (only the group holding the straddling ray reads its rays), and
// the scalars.
__global__ void __launch_bounds__(SCAN_THREADS)
march_scan_kernel(MarchArgs a, MarchWork w, int n_groups, unsigned char* __restrict__ truncated,
                  int* __restrict__ scalars) {
  __shared__ int warp_sums[32];
  __shared__ int s_total_c, s_total_f, s_first_group, s_cut_c, s_cut_f;
  const int tid = threadIdx.x;
  const int chunk = (n_groups + SCAN_THREADS - 1) / SCAN_THREADS;
  const int g0 = min(tid * chunk, n_groups), g1 = min(g0 + chunk, n_groups);
  if (tid == 0) {
    s_first_group = n_groups;
    s_cut_c = a.n_rays;
    s_cut_f = a.n_rays;
  }
  int sum = 0;
  for (int g = g0; g < g1; ++g) sum += w.blk_cand[g];
  const int cbase = scan_exclusive_sum(sum, warp_sums, &s_total_c);
  int c = cbase, hsum = 0;
  for (int g = g0; g < g1; ++g) {
    const int gc = w.blk_cand[g];
    int kh = 0;
    if (c + gc <= a.cap_c) {
      kh = w.blk_hit[g];
    } else if (c < a.cap_c) {
      for (int r = g * MARCH_WARPS, cr = c; r < min((g + 1) * MARCH_WARPS, a.n_rays); ++r) {
        kh += kept_hits(a, w, r, cr);
        cr += w.n_cand[r];
      }
    }
    if (gc > 0 && c <= a.cap_c - 1 && a.cap_c - 1 < c + gc) {
      // the ray holding candidate cap_c - 1
      for (int r = g * MARCH_WARPS, cr = c;; ++r) {
        cr += w.n_cand[r];
        if (a.cap_c - 1 < cr) {
          s_cut_c = r;
          break;
        }
      }
    }
    if (gc > 0) atomicMin(&s_first_group, g);
    w.blk_coff[g] = c;
    w.blk_foff[g] = kh;
    hsum += kh;
    c += gc;
  }
  const int fbase = scan_exclusive_sum(hsum, warp_sums, &s_total_f);
  int f = fbase;
  for (int g = g0; g < g1; ++g) {
    const int kh = w.blk_foff[g];
    w.blk_foff[g] = f;
    if (kh > 0 && f <= a.capacity - 1 && a.capacity - 1 < f + kh) {
      // the ray holding slot capacity - 1
      for (int r = g * MARCH_WARPS, cr = w.blk_coff[g], fr = f;; ++r) {
        fr += kept_hits(a, w, r, cr);
        cr += w.n_cand[r];
        if (a.capacity - 1 < fr) {
          s_cut_f = r;
          break;
        }
      }
    }
    f += kh;
  }
  __syncthreads();
  if (tid == 0) {
    const int tc = s_total_c, tf = s_total_f;
    *truncated = (tf > a.capacity || tc > a.cap_c) ? 1 : 0;
    scalars[0] = tf > a.capacity ? s_cut_f : (tc > a.cap_c ? s_cut_c : a.n_rays);
    const int kept_c = max(min(tc, a.cap_c), 1);
    const float est = static_cast<float>(tf) * static_cast<float>(tc) / static_cast<float>(kept_c);
    scalars[1] = static_cast<int>(est);
    // the padding: the zero-filled compaction points it at the first
    // candidate block's first step (ray 0, step 0 without a candidate)
    int ray = 0, step = 0;
    if (s_first_group < n_groups) {
      const int code = w.blk_first[s_first_group];
      ray = code / a.nb;
      step = (code % a.nb) * a.b;
    }
    w.meta[0] = tf;
    w.meta[1] = __float_as_int(w.tmin[ray] + (static_cast<float>(step) + 0.5f) * a.dt);
  }
}

struct MarchOut {
  int* ray_id;
  float* t_mid;
  unsigned char* valid;
};

// Write the hits of one ballot at slots first + written + rank, up to the
// capacity; `last_t` follows the last one written.
__device__ __forceinline__ void emit_hits(const MarchOut& o, int capacity, int r, int first,
                                          bool hit, float tf, int lane, int& written,
                                          float& last_t) {
  const unsigned m = __ballot_sync(FULL, hit);
  const int avail = capacity - (first + written);
  const int rank = __popc(m & ((1u << lane) - 1u));
  if (hit && rank < avail) {
    const int slot = first + written + rank;
    o.ray_id[slot] = r;
    o.t_mid[slot] = tf;
    o.valid[slot] = 1;
  }
  const int put = min(__popc(m), avail);
  if (put > 0) {
    const unsigned at = __ballot_sync(FULL, hit && rank == put - 1);
    last_t = __shfl_sync(FULL, tf, __ffs(at) - 1);
  }
  written += max(put, 0);
}

__global__ void __launch_bounds__(MARCH_WARPS * 32)
march_write_kernel(MarchArgs a, MarchWork w, MarchOut o, int* __restrict__ ray_hits,
                   float* __restrict__ ray_last_t) {
  __shared__ int s_nc[MARCH_WARPS], s_nh[MARCH_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * MARCH_WARPS + warp;
  if (lane == 0) {
    s_nc[warp] = r < a.n_rays ? w.n_cand[r] : 0;
    s_nh[warp] = r < a.n_rays ? w.n_hit[r] : 0;
  }
  __syncthreads();
  if (r < a.n_rays) {
    // this ray's first candidate's rank and first slot; when any of its
    // candidates is kept, every earlier ray of the group is kept whole
    int c = w.blk_coff[blockIdx.x], first = w.blk_foff[blockIdx.x];
    for (int i = 0; i < warp; ++i) {
      c += s_nc[i];
      first += s_nh[i];
    }
    const int k = min(max(a.cap_c - c, 0), s_nc[warp]);
    int written = 0;
    float last_t = __int_as_float(0xff800000);   // -inf
    if (k > 0 && first < a.capacity) {
      const Box box = load_box(a.aabb);
      Ray ray = load_ray(a.rays_o, a.rays_d, r);
      ray.tmin = w.tmin[r];
      ray.tmax = w.tmax[r];
      const unsigned char* hb = w.hits + static_cast<long long>(r) * a.nb;
      int seen = 0;
      for (int base = 0; base < a.nb && seen < k && first + written < a.capacity; base += 32) {
        const int blk = base + lane;
        const int h = blk < a.nb ? hb[blk] : NOT_CAND;
        unsigned cm = __ballot_sync(FULL, h != NOT_CAND);
        // the kept candidates: the first k - seen of this chunk's
        const int need = k - seen;
        while (__popc(cm) > need) cm &= ~(1u << (31 - __clz(cm)));
        seen += __popc(cm);
        unsigned hm = __ballot_sync(FULL, h != NOT_CAND && h > 0) & cm;
        while (hm && first + written < a.capacity) {
          const int bit = __ffs(hm) - 1;
          hm &= hm - 1;
          for (int j0 = 0; j0 < a.b && first + written < a.capacity; j0 += 64) {
            float t1 = 0.f, t2 = 0.f;
            const int j1 = j0 + lane, j2 = j1 + 32;
            const bool h1 = j1 < a.b && fine_test(ray, box, base + bit, j1, a.b, a.max_steps,
                                                  a.dt, a.binaries, a.res, &t1);
            const bool h2 = j2 < a.b && fine_test(ray, box, base + bit, j2, a.b, a.max_steps,
                                                  a.dt, a.binaries, a.res, &t2);
            emit_hits(o, a.capacity, r, first, h1, t1, lane, written, last_t);
            if (first + written < a.capacity)
              emit_hits(o, a.capacity, r, first, h2, t2, lane, written, last_t);
          }
        }
      }
    }
    if (lane == 0) {
      ray_hits[r] = written;
      ray_last_t[r] = last_t;
    }
  }
  // the padding slots, by the whole grid
  const int tf = w.meta[0];
  const float pad_t = __int_as_float(w.meta[1]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long slot = min(tf, a.capacity) + static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       slot < a.capacity; slot += stride) {
    o.ray_id[slot] = a.n_rays - 1;
    o.t_mid[slot] = pad_t;
    o.valid[slot] = 0;
  }
}

}  // namespace

// One march: rays_o/rays_d [n_rays, 3] f32, aabb [6] f32, t_start [n_rays]
// f32 or null, ray_mask [n_rays] uint8 or null, jitter [n_rays] f32
// uniforms or null, mip [mres^3] uint8, binaries [res^3] uint8.  Workspace:
// tmin, tmax [n_rays] f32; ints [cnc_march_ints(n_rays)] int32; hits
// [n_rays * nb] uint8.  Writes ray_id [capacity] int32, t_mid [capacity] f32,
// valid [capacity] uint8, truncated [1] uint8, scalars [2] int32 =
// (resume_ray, num_samples), ray_hits [n_rays] int32 and ray_last_t [n_rays]
// f32.  Three launches: count, scan, write.  b <= 254.
CNC_EXPORT long long cnc_march_ints(int n_rays) {
  const long long groups = (n_rays + MARCH_WARPS - 1) / MARCH_WARPS;
  return 2ll * n_rays + 5 * groups + 2;
}

CNC_EXPORT int cnc_march(const float* rays_o, const float* rays_d, const float* aabb,
                         const float* t_start, const unsigned char* ray_mask, const float* jitter,
                         const unsigned char* mip, int mres, const unsigned char* binaries,
                         int res, int n_rays, int nb, int b, int max_steps, int cap_c,
                         int capacity, float bdt, float dt, float near, float far, float clip_hi,
                         float* tmin, float* tmax, int* ints, unsigned char* hits, int* ray_id,
                         float* t_mid, unsigned char* valid, unsigned char* truncated,
                         int* scalars, int* ray_hits, float* ray_last_t, void* stream) {
  if (n_rays <= 0 || b <= 0 || b >= NOT_CAND || capacity <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (n_rays + MARCH_WARPS - 1) / MARCH_WARPS;
  const MarchArgs a{rays_o, rays_d, aabb, t_start, ray_mask, jitter, mip, binaries,
                    mres, res, n_rays, nb, b, max_steps, cap_c, capacity,
                    bdt, dt, near, far, clip_hi};
  int* p = ints;
  MarchWork w;
  w.tmin = tmin;
  w.tmax = tmax;
  w.n_cand = p;
  w.n_hit = p += n_rays;
  w.blk_cand = p += n_rays;
  w.blk_hit = p += groups;
  w.blk_first = p += groups;
  w.blk_coff = p += groups;
  w.blk_foff = p += groups;
  w.meta = p += groups;
  w.hits = hits;
  march_count_kernel<<<groups, MARCH_WARPS * 32, 0, s>>>(a, w);
  int rc = cnc_last_error();
  if (rc != 0) return rc;
  march_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a, w, groups, truncated, scalars);
  rc = cnc_last_error();
  if (rc != 0) return rc;
  march_write_kernel<<<groups, MARCH_WARPS * 32, 0, s>>>(a, w, MarchOut{ray_id, t_mid, valid},
                                                        ray_hits, ray_last_t);
  return cnc_last_error();
}

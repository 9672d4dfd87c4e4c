// K4: the two-pass occupancy ray march (coarse block cull, fine step test).
//
// Replaces: cnc_tpu/render/marching.py march_rays (112-210), with
// ray_aabb_intersect (58-68) and occupancy_lookup (71-81) inlined.  The
// dilated mip (build_march_mip, 84-101) stays plain torch: it is built once
// per chunk.  The two compactions between the passes are K3 (compact.cu).
// Plain twin: cnc_torch/render/marching.py `_march_plain`.
//
// Structure and buffers are cnc_tpu's, so the sample sets are identical,
// truncation included:
//   coarse: one thread per (ray, block of B steps) tests the block midpoint
//           against the dilated 16^3 mip -> candidate mask [R, NB];
//   K3 compacts it to cap_c = max(256, capacity // 4);
//   fine:   one thread per (candidate, step) tests the step midpoint against
//           the full-resolution grid -> hit mask [cap_c, B];
//   K3 compacts it to `capacity`;
//   finish: one thread per output slot decodes (ray, step) -> ray_id, t_mid,
//           valid with padding parked on ray R-1, plus truncated, resume_ray
//           and the hit-count estimate.
//
// Exactness: this file is compiled with -fmad=false, so o + d*t and
// (pos-lo)/(hi-lo)*res are rounded after each operation as in the twin (an
// FMA moves them by an ulp and can flip a voxel).  All float constants
// (b*dt, dt, 1-1e-6, near, far) arrive already rounded to f32 by the wrapper,
// as JAX rounds its weak-typed Python scalars.
//
// Bound on the H100: bytes.  Reads the rays (24 B each), the 4 KB mip and the
// 128^3 grid bytes it touches (at most 2 MB), writes capacity * 9 B of
// samples.  The passes do a few dozen flops per test; at the main path's
// 8,192 rays the work is a few microseconds of HBM time, so the five launches
// and their latency dominate.

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

__global__ void coarse_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                              const float* __restrict__ aabb, const float* __restrict__ t_start,
                              const unsigned char* __restrict__ ray_mask,
                              const float* __restrict__ jitter,
                              const unsigned char* __restrict__ mip, int mres, int n_rays,
                              int nb, float bdt, float dt, float near, float far, float clip_hi,
                              float* __restrict__ tmin_out, float* __restrict__ tmax_out,
                              unsigned char* __restrict__ cand) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_rays) * nb) return;
  const int r = static_cast<int>(t / nb);
  const int blk = static_cast<int>(t % nb);
  const Box box = load_box(aabb);
  const float* o = rays_o + 3ll * r;
  const float* d = rays_d + 3ll * r;
  float tmin, tmax;
  ray_span(o, d, box, near, far, t_start ? t_start[r] : 0.f, t_start != nullptr,
           jitter ? jitter[r] : 0.f, jitter != nullptr, dt, &tmin, &tmax);
  if (blk == 0) {
    tmin_out[r] = tmin;
    tmax_out[r] = tmax;
  }
  const bool hit = tmin < tmax && (ray_mask == nullptr || ray_mask[r]);
  const float bi = static_cast<float>(blk);
  const float tc = tmin + (bi + 0.5f) * bdt;
  int vox[3];
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + d[a] * tc;
    float x01 = (p - box.lo[a]) / (box.hi[a] - box.lo[a]);
    x01 = fminf(fmaxf(x01, 0.f), clip_hi);
    vox[a] = static_cast<int>(x01 * static_cast<float>(mres));
  }
  const bool occ = mip[(static_cast<long long>(vox[0]) * mres + vox[1]) * mres + vox[2]] != 0;
  const float blk_start = tmin + bi * bdt;
  cand[t] = (occ && blk_start < tmax && hit) ? 1 : 0;
}

__global__ void fine_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                            const float* __restrict__ aabb, const float* __restrict__ tmin_in,
                            const float* __restrict__ tmax_in, const int* __restrict__ src_c,
                            const int* __restrict__ total_c, int cap_c, int nb, int b,
                            int max_steps, float dt, const unsigned char* __restrict__ binaries,
                            int res, unsigned char* __restrict__ bits) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(cap_c) * b) return;
  const int k = static_cast<int>(t / b);
  const int j = static_cast<int>(t % b);
  if (k >= min(*total_c, cap_c)) {
    bits[t] = 0;
    return;
  }
  const int c = src_c[k];
  const int r = c / nb;
  const int blk = c % nb;
  const float step_f = static_cast<float>(blk) * static_cast<float>(b) + static_cast<float>(j);
  const float tf = tmin_in[r] + (step_f + 0.5f) * dt;
  const Box box = load_box(aabb);
  bool inside = true;
  int vox[3];
  for (int a = 0; a < 3; ++a) {
    const float p = rays_o[3ll * r + a] + rays_d[3ll * r + a] * tf;
    const float x01 = (p - box.lo[a]) / (box.hi[a] - box.lo[a]);
    inside &= x01 >= 0.f && x01 < 1.f;
    const int v = static_cast<int>(x01 * static_cast<float>(res));
    vox[a] = min(max(v, 0), res - 1);
  }
  bool occ = false;
  if (inside)
    occ = binaries[(static_cast<long long>(vox[0]) * res + vox[1]) * res + vox[2]] != 0;
  bits[t] = (occ && tf < tmax_in[r] && step_f < static_cast<float>(max_steps)) ? 1 : 0;
}

__device__ __forceinline__ void decode_slot(int sf, const int* __restrict__ src_c, int nb, int b,
                                            int* ray, int* step) {
  const int c = src_c[sf / b];
  *ray = c / nb;
  *step = (c % nb) * b + sf % b;
}

__global__ void finish_kernel(const float* __restrict__ tmin_in, const int* __restrict__ src_c,
                              const int* __restrict__ total_c, int cap_c,
                              const int* __restrict__ src_f, const int* __restrict__ total_f,
                              int capacity, int nb, int b, int n_rays, float dt,
                              int* __restrict__ ray_id, float* __restrict__ t_mid,
                              unsigned char* __restrict__ valid, int* __restrict__ scalars) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int tf = *total_f, tc = *total_c;
  if (k < capacity) {
    int ray, step;
    decode_slot(src_f[k], src_c, nb, b, &ray, &step);
    const bool fvalid = k < min(tf, capacity);
    t_mid[k] = tmin_in[ray] + (static_cast<float>(step) + 0.5f) * dt;
    ray_id[k] = fvalid ? ray : n_rays - 1;
    valid[k] = fvalid ? 1 : 0;
  }
  if (k == 0) {
    // scalars: [truncated, resume_ray, num_samples]
    scalars[0] = (tf > capacity || tc > cap_c) ? 1 : 0;
    int resume = n_rays;
    if (tf > capacity) {
      int step;
      decode_slot(src_f[capacity - 1], src_c, nb, b, &resume, &step);
    } else if (tc > cap_c) {
      resume = src_c[cap_c - 1] / nb;
    }
    scalars[1] = resume;
    const int kept_c = max(min(tc, cap_c), 1);
    const float est = static_cast<float>(tf) * static_cast<float>(tc) / static_cast<float>(kept_c);
    scalars[2] = static_cast<int>(est);
  }
}

}  // namespace

// Coarse pass.  rays_o/rays_d [n_rays, 3] f32, aabb [6] f32, t_start [n_rays]
// f32 or null, ray_mask [n_rays] uint8 or null, jitter [n_rays] f32 uniforms
// or null, mip [mres^3] uint8; writes tmin/tmax [n_rays] f32 and cand
// [n_rays * nb] uint8.
CNC_EXPORT int cnc_march_coarse(const float* rays_o, const float* rays_d, const float* aabb,
                                const float* t_start, const unsigned char* ray_mask,
                                const float* jitter, const unsigned char* mip, int mres,
                                int n_rays, int nb, float bdt, float dt, float near, float far,
                                float clip_hi, float* tmin, float* tmax, unsigned char* cand,
                                void* stream) {
  if (n_rays == 0) return 0;
  const int threads = 256;
  coarse_kernel<<<cnc_blocks(static_cast<long long>(n_rays) * nb, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(rays_o, rays_d, aabb, t_start, ray_mask,
                                                       jitter, mip, mres, n_rays, nb, bdt, dt,
                                                       near, far, clip_hi, tmin, tmax, cand);
  return cnc_last_error();
}

// Fine pass over the compacted candidates src_c [cap_c] (count total_c [1]);
// binaries [res^3] uint8; writes bits [cap_c * b] uint8.
CNC_EXPORT int cnc_march_fine(const float* rays_o, const float* rays_d, const float* aabb,
                              const float* tmin, const float* tmax, const int* src_c,
                              const int* total_c, int cap_c, int nb, int b, int max_steps,
                              float dt, const unsigned char* binaries, int res,
                              unsigned char* bits, void* stream) {
  const int threads = 256;
  fine_kernel<<<cnc_blocks(static_cast<long long>(cap_c) * b, threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(rays_o, rays_d, aabb, tmin, tmax, src_c,
                                                     total_c, cap_c, nb, b, max_steps, dt,
                                                     binaries, res, bits);
  return cnc_last_error();
}

// Decode the compacted hits src_f [capacity] (count total_f [1]) into
// ray_id [capacity] int32, t_mid [capacity] f32, valid [capacity] uint8 and
// scalars [3] int32 = (truncated, resume_ray, num_samples).
CNC_EXPORT int cnc_march_finish(const float* tmin, const int* src_c, const int* total_c,
                                int cap_c, const int* src_f, const int* total_f, int capacity,
                                int nb, int b, int n_rays, float dt, int* ray_id, float* t_mid,
                                unsigned char* valid, int* scalars, void* stream) {
  const int threads = 256;
  finish_kernel<<<cnc_blocks(capacity, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(tmin, src_c, total_c, cap_c, src_f,
                                                       total_f, capacity, nb, b, n_rays, dt,
                                                       ray_id, t_mid, valid, scalars);
  return cnc_last_error();
}

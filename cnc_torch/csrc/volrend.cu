// K5: volume rendering forward over a compacted, ray-sorted sample buffer.
//
// Replaces: cnc_tpu/ops/scan.py segment_exclusive_sum (47-54, a segmented
// associative scan in XLA) and cnc_tpu/render/volrend.py render_weights and
// composite (43-91, three sorted segment sums).
// Plain twin: cnc_torch/render/volrend.py `_composite_plain`.
//
// Per contiguous ray segment: sdt = sigma*dt on valid samples; alpha =
// 1-exp(-sdt) with the alpha_thre cull; the exclusive prefix of sdt;
// T = exp(-prefix) * prefix_trans[ray]; visible where T >= early_stop_eps and
// valid; w = T*alpha; the sums of w*rgb, w and w*t_mid into [R,3], [R], [R];
// and the visible count.  Padding samples are parked on ray R-1 with
// valid = 0 after that ray's real samples: they add sdt = 0 and w = 0.
//
// Bound on the H100: bytes.  Each sample is read once (sigma 4, rgb 12,
// t_mid 4, valid 1, ray_id 4 = 25 B), each ray written once (20 B); about
// 1.8 MB at the main path's 65,536 samples and 8,192 rays, i.e. ~0.5 us of
// HBM time.  Two exps per sample; the work is serial within a ray.
//
// Simple design, as nerfacc's per-ray scans: one thread per ray finds its
// segment [start, end) by binary search in the sorted ray_id (no
// head-marking pass, no scratch), then walks its valid samples serially,
// keeping the running sum in a register.  The prefix is formed as
// (running + sdt) - sdt, the same inclusive-minus-value form cnc_tpu uses.
//
// Precondition: within each segment the valid samples come first, as every
// producer of sample buffers emits them (the march's padding is the buffer's
// tail, parked on ray R-1).  The walk stops at the segment's first invalid
// sample, found by a third binary search: without it, the thread of ray R-1
// walked every padding slot serially (up to the whole 65,536-slot buffer in
// the late rounds of a view, 3.3 ms per launch), which made this kernel 72%
// of the device time of an 800x800 view.  Invalid samples add sdt = 0 and
// w = 0, so stopping there changes no sum.

#include "common.cuh"

namespace {

// First index in [lo, hi) where pred(i) is false; pred is true then false.
template <typename Pred>
__device__ __forceinline__ int partition_point(int lo, int hi, Pred pred) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void volrend_forward_kernel(const float* __restrict__ sigmas,
                                       const float* __restrict__ rgbs,
                                       const float* __restrict__ t_mid,
                                       const unsigned char* __restrict__ valid,
                                       const int* __restrict__ ray_id,
                                       const float* __restrict__ prefix_trans, int n_samples,
                                       int n_rays, float dt, float early_stop_eps,
                                       float alpha_thre, float* __restrict__ rgb_out,
                                       float* __restrict__ opacity_out,
                                       float* __restrict__ depth_out, int* __restrict__ n_visible) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float pt = prefix_trans ? prefix_trans[r] : 1.f;
  float run = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, op = 0.f, dep = 0.f;
  int vis_count = 0;
  const int start = partition_point(0, n_samples, [&](int i) { return ray_id[i] < r; });
  const int end = partition_point(start, n_samples, [&](int i) { return ray_id[i] == r; });
  const int vend = partition_point(start, end, [&](int i) { return valid[i] != 0; });
  for (int i = start; i < vend; ++i) {
    float sdt = sigmas[i] * dt;
    float alpha = 1.f - expf(-sdt);
    if (alpha_thre > 0.f && !(alpha >= alpha_thre)) {
      sdt = 0.f;
      alpha = 0.f;
    }
    const float incl = run + sdt;
    const float prefix = incl - sdt;
    run = incl;
    const float trans = expf(-prefix) * pt;
    if (trans >= early_stop_eps) {
      const float w = trans * alpha;
      cr += w * rgbs[3ll * i];
      cg += w * rgbs[3ll * i + 1];
      cb += w * rgbs[3ll * i + 2];
      op += w;
      dep += w * t_mid[i];
      ++vis_count;
    }
  }
  rgb_out[3ll * r] = cr;
  rgb_out[3ll * r + 1] = cg;
  rgb_out[3ll * r + 2] = cb;
  opacity_out[r] = op;
  depth_out[r] = dep;
  if (vis_count) atomicAdd(n_visible, vis_count);
}

}  // namespace

// sigmas [S] f32, rgbs [S,3] f32, t_mid [S] f32, valid [S] uint8, ray_id [S]
// int32 sorted ascending, prefix_trans [R] f32 or null; writes rgb [R,3],
// opacity [R], depth [R] f32 and n_visible [1] int32.
CNC_EXPORT int cnc_volrend_forward(const float* sigmas, const float* rgbs, const float* t_mid,
                                   const unsigned char* valid, const int* ray_id,
                                   const float* prefix_trans, int n_samples, int n_rays,
                                   float dt, float early_stop_eps, float alpha_thre,
                                   float* rgb_out, float* opacity_out, float* depth_out,
                                   int* n_visible, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaMemsetAsync(n_visible, 0, sizeof(int), s));
  if (rc || n_rays == 0) return rc;
  const int threads = 128;
  volrend_forward_kernel<<<cnc_blocks(n_rays, threads), threads, 0, s>>>(
      sigmas, rgbs, t_mid, valid, ray_id, prefix_trans, n_samples, n_rays, dt, early_stop_eps,
      alpha_thre, rgb_out, opacity_out, depth_out, n_visible);
  return cnc_last_error();
}

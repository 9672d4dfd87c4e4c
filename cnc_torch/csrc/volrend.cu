// K5 and K5b: volume rendering, forward and backward, over a compacted,
// ray-sorted sample buffer.
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
// K5b, the backward, replaces the autodiff of the same cnc_tpu functions
// (render/volrend.py 43-91; reference scan.cu:206-214).  Plain twin: autograd
// of `_composite_plain`.  With G_i = d_rgb . rgb_i + d_opacity + d_depth * t_i
// over the ray's visible samples,
//   d_rgb_i   = w_i * d_rgb[ray]
//   d_sigma_i = dt * (vis_i * G_i * T_i * (1 - alpha_i) - sum_{k>i} G_k * w_k),
// and a sample cut by alpha_thre gets no gradient and contributes none.
// `visible` and prefix_trans carry no gradient; an absent output gradient is
// a null pointer and reads as 0.
//
// Bound on the H100: bytes.  Each valid sample is read once (sigma 4, rgb 12,
// t_mid 4, valid 1, ray_id 4 = 25 B), each ray written once (20 B); the
// backward also writes 16 B of gradient per sample.  About 1.8 MB at a view
// round's 65,536 samples and 8,192 rays, i.e. ~0.5 us of HBM time; two exps
// per sample.
//
// Design.  Two launches per call, no search over the buffer:
//  1. `walk_ranges_kernel` (twin: render/volrend.py `_walk_ranges_plain`),
//     one thread per sample, reads the ray ids and valid flags coalesced and
//     writes each ray's walk [start, end) into a table of two ints a ray: a
//     segment's head (ray_id[i] != ray_id[i-1]) writes its start, and the
//     segment's last valid sample writes its end (the head itself when the
//     segment has no valid sample).  Precondition: within each segment the
//     valid samples come first, as every producer of sample buffers emits
//     them (the march's padding is the buffer's tail, parked on ray R-1; the
//     training prefilter parks its own on n_rays - 1).  So no ray walks
//     padding: without the end, ray R-1 walked up to the whole 65,536-slot
//     buffer in a view's late rounds (3.3 ms a launch).  Rays without a
//     segment keep the table's [0, 0).  The scan kernel resets each entry it
//     reads to [0, 0), so the table (cached per device and stream by the
//     wrapper) is all zero between calls and needs no memset.  The forward's
//     first launch also clears the visible count; the backward's writes the
//     zero gradients of the samples no ray walks.  It also sets a fault word
//     where the precondition fails (a valid sample after an invalid one in
//     its segment, or ray ids that decrease): such a buffer's walks, and the
//     backward's gradients of its samples outside them, are undefined.
//  2. the scan: a warp of 32 lanes per ray.  Each pass takes 32 consecutive
//     samples of the ray, one a lane, so every load is coalesced, and issues
//     the next pass's loads before its own scan; a shuffle scan gives the
//     pass's inclusive sums of sdt and a carry takes them across passes, so
//     rays of any length work.  A ray's passes are a chain, and a march that
//     fills its buffer leaves few rays with many samples (a view's first
//     round: 477 of 8,192 rays, 137 samples on average, 282 at most), so the
//     lanes a ray, not the mean slots per ray, set the time (16-lane groups
//     were slower than 32 at the 16,384-ray training march, PERF.md).  The
//     prefix is formed as (carry + inclusive) - sdt, cnc_tpu's
//     inclusive-minus-value form, in double and rounded to float once: as
//     exact as the twin's float64 sums, so the transmittance and the visible
//     count come out as the twin's.  The forward then reduces w*rgb, w and
//     w*t_mid over the warp, and a block adds its visible count with one
//     integer atomic.
//     K5b walks each ray twice: once for S = sum_k G_k * w_k (double, a
//     warp reduction), once more, rebuilding T, alpha and w with the very
//     same operations, for each sample's suffix as S minus its inclusive scan
//     of G*w.  It writes every walked sample's gradients (zeros where not
//     visible or cut); no float atomics, so two runs are bit-equal.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLanes = 32;  // one warp per ray

__device__ __forceinline__ double warp_inclusive_sum(double x, int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const double y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The sum over the warp, the same bits in every lane (a butterfly).
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// One sample of a warp's pass: its alpha with the cull, its transmittance
// from the exclusive prefix of sdt, and whether it is visible; advances the
// carry by the pass's total.  Inactive lanes (past the ray's end) add 0.
struct Step {
  float alpha, trans;
  bool visible, cut;
};

__device__ __forceinline__ Step walk_pass(bool active, float sigma, float dt, float alpha_thre,
                                          float pt, float early_stop_eps, int lane,
                                          double* carry) {
  Step s;
  float sdt = active ? sigma * dt : 0.f;
  s.alpha = 1.f - expf(-sdt);
  s.cut = alpha_thre > 0.f && !(s.alpha >= alpha_thre);
  if (s.cut) {
    sdt = 0.f;
    s.alpha = 0.f;
  }
  const double incl = *carry + warp_inclusive_sum(static_cast<double>(sdt), lane);
  const float prefix = static_cast<float>(incl - static_cast<double>(sdt));
  *carry = __shfl_sync(kFull, incl, kLanes - 1);
  s.trans = expf(-prefix) * pt;
  s.visible = active && s.trans >= early_stop_eps;
  return s;
}

// G_i, with its roundings pinned so both of K5b's walks get the same bits.
__device__ __forceinline__ float grad_of(float gr, float gg, float gb, float go, float gd,
                                         float red, float green, float blue, float t) {
  const float c = __fmaf_rn(gb, blue, __fmaf_rn(gg, green, __fmul_rn(gr, red)));
  return __fadd_rn(__fadd_rn(c, go), __fmul_rn(gd, t));
}

// The ray of this thread's warp and its walk [start, end), read from the
// table by the warp's first lane, which leaves the entry [0, 0).
__device__ __forceinline__ int2 take_range(int* ranges, int r, int n_rays, int lane) {
  int2 range = make_int2(0, 0);
  if (lane == 0 && r < n_rays) {
    int2* entry = reinterpret_cast<int2*>(ranges) + r;
    range = *entry;
    *entry = make_int2(0, 0);
  }
  range.x = __shfl_sync(kFull, range.x, 0);
  range.y = __shfl_sync(kFull, range.y, 0);
  return range;
}

__global__ void walk_ranges_kernel(const int* __restrict__ ray_id,
                                   const unsigned char* __restrict__ valid, int n_samples,
                                   int n_rays, int* __restrict__ ranges, int* n_visible,
                                   int* faults, float* __restrict__ d_sigmas,
                                   float* __restrict__ d_rgbs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 && n_visible) *n_visible = 0;
  if (i >= n_samples) return;
  const int r = ray_id[i];
  const bool in_range = r >= 0 && r < n_rays;
  const bool v = valid[i] != 0;
  if (in_range) {
    const int prev = i > 0 ? ray_id[i - 1] : -1;
    if (prev > r || (prev == r && v && !valid[i - 1])) *faults = 1;
    if (prev != r) {
      ranges[2 * r] = i;
      if (!v) ranges[2 * r + 1] = i;
    }
    if (v && (i + 1 == n_samples || ray_id[i + 1] != r || !valid[i + 1]))
      ranges[2 * r + 1] = i + 1;
  }
  if (d_sigmas && !(in_range && v)) {
    d_sigmas[i] = 0.f;
    d_rgbs[3ll * i] = 0.f;
    d_rgbs[3ll * i + 1] = 0.f;
    d_rgbs[3ll * i + 2] = 0.f;
  }
}

// A sample's inputs, read by its lane of the warp (zeros past the ray's end).
struct Sample {
  float sigma, red, green, blue, t;
};

__device__ __forceinline__ Sample load_sample(const float* __restrict__ sigmas,
                                              const float* __restrict__ rgbs,
                                              const float* __restrict__ t_mid, int i,
                                              bool active) {
  Sample x{0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    x.sigma = sigmas[i];
    x.red = rgbs[3ll * i];
    x.green = rgbs[3ll * i + 1];
    x.blue = rgbs[3ll * i + 2];
    x.t = t_mid[i];
  }
  return x;
}

// Walks a warp's ray pass by pass, calling visit(x, step, i, active) for
// each lane's sample.  The next pass's loads are issued before this pass's
// scan, so a long ray's passes wait on their loads once, not once a pass.
template <typename Visit>
__device__ __forceinline__ void walk(const float* __restrict__ sigmas,
                                     const float* __restrict__ rgbs,
                                     const float* __restrict__ t_mid, int2 range, int passes,
                                     float dt, float alpha_thre, float pt, float early_stop_eps,
                                     int lane, Visit visit) {
  double carry = 0.0;
  int i = range.x + lane;
  Sample x = load_sample(sigmas, rgbs, t_mid, i, i < range.y);
  for (int p = 0; p < passes; ++p, i += kLanes) {
    const bool active = i < range.y;
    const Sample next = load_sample(sigmas, rgbs, t_mid, i + kLanes, i + kLanes < range.y);
    const Step s = walk_pass(active, x.sigma, dt, alpha_thre, pt, early_stop_eps, lane,
                                &carry);
    visit(x, s, i, active);
    x = next;
  }
}

__global__ void __launch_bounds__(kThreads)
    volrend_forward_kernel(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                           const float* __restrict__ t_mid, int* __restrict__ ranges,
                           const float* __restrict__ prefix_trans, int n_rays, float dt,
                           float early_stop_eps, float alpha_thre, float* __restrict__ rgb_out,
                           float* __restrict__ opacity_out, float* __restrict__ depth_out,
                           int* __restrict__ n_visible) {
  __shared__ int warp_counts[kThreads / kLanes];
  const int lane = threadIdx.x % kLanes;
  const int r = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int2 range = take_range(ranges, r, n_rays, lane);
  const float pt = prefix_trans && r < n_rays ? prefix_trans[r] : 1.f;
  const int passes = (range.y - range.x + kLanes - 1) / kLanes;
  float cr = 0.f, cg = 0.f, cb = 0.f, op = 0.f, dep = 0.f;
  int count = 0;
  walk(sigmas, rgbs, t_mid, range, passes, dt, alpha_thre, pt, early_stop_eps, lane,
          [&](const Sample& x, const Step& s, int, bool) {
            if (s.visible) {
              const float w = s.trans * s.alpha;
              cr += w * x.red;
              cg += w * x.green;
              cb += w * x.blue;
              op += w;
              dep += w * x.t;
              ++count;
            }
          });
  cr = warp_sum(cr);
  cg = warp_sum(cg);
  cb = warp_sum(cb);
  op = warp_sum(op);
  dep = warp_sum(dep);
  if (lane == 0 && r < n_rays) {
    rgb_out[3ll * r] = cr;
    rgb_out[3ll * r + 1] = cg;
    rgb_out[3ll * r + 2] = cb;
    opacity_out[r] = op;
    depth_out[r] = dep;
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) warp_counts[threadIdx.x / kLanes] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / kLanes; ++w) total += warp_counts[w];
    if (total) atomicAdd(n_visible, total);
  }
}

__global__ void __launch_bounds__(kThreads)
    volrend_backward_kernel(const float* __restrict__ sigmas, const float* __restrict__ rgbs,
                            const float* __restrict__ t_mid, int* __restrict__ ranges,
                            const float* __restrict__ prefix_trans,
                            const float* __restrict__ d_rgb, const float* __restrict__ d_opacity,
                            const float* __restrict__ d_depth, int n_rays, float dt,
                            float early_stop_eps, float alpha_thre,
                            float* __restrict__ d_sigmas, float* __restrict__ d_rgbs) {
  const int lane = threadIdx.x % kLanes;
  const int r = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int2 range = take_range(ranges, r, n_rays, lane);
  float pt = 1.f, gr = 0.f, gg = 0.f, gb = 0.f, go = 0.f, gd = 0.f;
  if (r < n_rays) {
    if (prefix_trans) pt = prefix_trans[r];
    if (d_rgb) {
      gr = d_rgb[3ll * r];
      gg = d_rgb[3ll * r + 1];
      gb = d_rgb[3ll * r + 2];
    }
    if (d_opacity) go = d_opacity[r];
    if (d_depth) gd = d_depth[r];
  }
  const int passes = (range.y - range.x + kLanes - 1) / kLanes;
  // walk 1: S = sum over the visible samples of G_k * w_k
  double part = 0.0;
  walk(sigmas, rgbs, t_mid, range, passes, dt, alpha_thre, pt, early_stop_eps, lane,
          [&](const Sample& x, const Step& s, int, bool) {
            if (s.visible) {
              const float g = grad_of(gr, gg, gb, go, gd, x.red, x.green, x.blue, x.t);
              part += static_cast<double>(__fmul_rn(g, __fmul_rn(s.trans, s.alpha)));
            }
          });
  const double total = warp_sum(part);
  // walk 2: each sample's gradients, the suffix as S minus the inclusive sum
  double acc = 0.0;
  walk(sigmas, rgbs, t_mid, range, passes, dt, alpha_thre, pt, early_stop_eps, lane,
          [&](const Sample& x, const Step& s, int i, bool active) {
            float w = 0.f, own = 0.f, gw = 0.f;
            if (s.visible) {
              w = __fmul_rn(s.trans, s.alpha);
              const float g = grad_of(gr, gg, gb, go, gd, x.red, x.green, x.blue, x.t);
              gw = __fmul_rn(g, w);
              own = g * s.trans * (1.f - s.alpha);
            }
            const double incl = acc + warp_inclusive_sum(static_cast<double>(gw), lane);
            acc = __shfl_sync(kFull, incl, kLanes - 1);
            if (active) {
              d_rgbs[3ll * i] = w * gr;
              d_rgbs[3ll * i + 1] = w * gg;
              d_rgbs[3ll * i + 2] = w * gb;
              d_sigmas[i] = s.cut ? 0.f : dt * (own - static_cast<float>(total - incl));
            }
          });
}

unsigned scan_blocks(int n_rays) {
  return cnc_blocks(static_cast<long long>(n_rays) * kLanes, kThreads);
}

}  // namespace

// sigmas [S] f32, rgbs [S,3] f32, t_mid [S] f32, valid [S] uint8, ray_id [S]
// int32 sorted ascending, prefix_trans [R] f32 or null; `ranges` the walk
// table, [2 * n_rays] int32 all zero (and left so); `faults` one int32, set
// to 1 (never cleared) when the buffer breaks the precondition.  Writes
// rgb [R,3], opacity [R], depth [R] f32 and n_visible [1] int32.  Two
// launches.
CNC_EXPORT int cnc_volrend_forward(const float* sigmas, const float* rgbs, const float* t_mid,
                                   const unsigned char* valid, const int* ray_id,
                                   const float* prefix_trans, int n_samples, int n_rays,
                                   float dt, float early_stop_eps, float alpha_thre, int* ranges,
                                   int* faults, float* rgb_out, float* opacity_out,
                                   float* depth_out, int* n_visible, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  walk_ranges_kernel<<<cnc_blocks(n_samples, kThreads), kThreads, 0, s>>>(
      ray_id, valid, n_samples, n_rays, ranges, n_visible, faults, nullptr, nullptr);
  if (int rc = cnc_last_error()) return rc;
  volrend_forward_kernel<<<scan_blocks(n_rays), kThreads, 0, s>>>(
      sigmas, rgbs, t_mid, ranges, prefix_trans, n_rays, dt, early_stop_eps, alpha_thre,
      rgb_out, opacity_out, depth_out, n_visible);
  return cnc_last_error();
}

// K5b.  The forward's inputs plus the output gradients d_rgb [R,3], d_opacity
// [R], d_depth [R] f32, each may be null (read as 0); writes every entry of
// d_sigmas [S] and d_rgbs [S,3] f32.  Two launches.
CNC_EXPORT int cnc_volrend_backward(const float* sigmas, const float* rgbs, const float* t_mid,
                                    const unsigned char* valid, const int* ray_id,
                                    const float* prefix_trans, const float* d_rgb,
                                    const float* d_opacity, const float* d_depth,
                                    int n_samples, int n_rays, float dt, float early_stop_eps,
                                    float alpha_thre, int* ranges, int* faults, float* d_sigmas,
                                    float* d_rgbs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  walk_ranges_kernel<<<cnc_blocks(n_samples, kThreads), kThreads, 0, s>>>(
      ray_id, valid, n_samples, n_rays, ranges, nullptr, faults, d_sigmas, d_rgbs);
  if (int rc = cnc_last_error()) return rc;
  volrend_backward_kernel<<<scan_blocks(n_rays), kThreads, 0, s>>>(
      sigmas, rgbs, t_mid, ranges, prefix_trans, d_rgb, d_opacity, d_depth, n_rays, dt,
      early_stop_eps, alpha_thre, d_sigmas, d_rgbs);
  return cnc_last_error();
}

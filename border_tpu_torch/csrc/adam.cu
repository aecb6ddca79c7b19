// The Adam / AdamW step over a list of float32 tensors, one launch a list
// of up to kMaxTensors tensors.
//
// Replaces no TPU kernel: border_tpu's optimizers are optax transforms,
// which XLA fuses into the update's program.  In PyTorch the capturable
// multi-tensor Adam (torch.optim.Adam(capturable=True), the form a CUDA
// graph can replay) is a chain of 15 dependent _foreach launches a step,
// eight of them full passes over every parameter, plus two launches a
// tensor where a list is divided by the per-tensor bias corrections
// (torch's per-tensor path): 35 nodes of the trainer's update graph for
// DQN's 10 tensors.
//
// What bounds it on an H100: bytes.  An element reads p, g, m and v and
// writes p, m and v: 28 B, far below the ridge point (DQN's 1.69M
// parameters: 47.2 MB, 14.1 us at 3.35 TB/s).  A step over a few small
// tensors (SAC's 2 x 256 nets, its one-element log alpha) is bound by the
// launch and one round trip to memory instead.
//
// What the design does about it:
//  - one pass: each element is read once and written once, and every
//    intermediate stays in registers;
//  - the tensors' addresses and sizes travel in the launch's parameters
//    (by value, as torch's multi_tensor_apply does), so a captured graph's
//    node carries them and nothing on the device has to be kept in step;
//  - the blocks stride over the tensors laid end to end in units of four
//    elements, read and written as one 16-byte vector where all four of a
//    tensor's arrays are 16-byte aligned; the grid follows the element
//    count (one block for a one-element tensor, the whole card for DQN);
//  - the step counts: each block reads t at its start and derives the bias
//    corrections from t + 1; the last block to finish (a done-counter in
//    the caller's scratch, reset by that block) writes t + 1, so no block
//    reads a count another has already advanced, in one launch.
//
// It gives torch's capturable _multi_tensor_adam (torch/optim/adam.py) bit
// for bit: the same float32 operations in the same order, rounded where
// torch's kernels round (the _rn intrinsics keep nvcc from contracting or
// approximating) and fused where nvcc contracts torch's own expressions
// (lerp's m + w·(g − m) and addcmul's v + c·(g·g) are fmas there):
//   t ← t + 1; for AdamW first p ← p·(1 − lr·wd);
//   m ← lerp(m, g, 1 − β1); v ← v·β2; v ← v + (1 − β2)·(g·g);
//   step_size = 1 / ((β1^t − 1) / lr);  bc2 = √(−(β2^t − 1));
//   p ← p + m / (((√v / bc2) + eps) / step_size).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;  // keeps the parameters under 4 KB
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 64 registers a thread: 4 blocks an SM

struct AdamArgs {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* step[kMaxTensors];
  long long n[kMaxTensors];
  long long first[kMaxTensors];  // tensor i's first unit of four elements
  const float* lr;
  unsigned int* done;
  int count;
  float beta1, beta2, lerp_weight, one_minus_beta2, eps, weight_decay;
  int decoupled;  // AdamW's p·(1 − lr·wd) first
};

// at::native::lerp (ATen/native/Lerp.h) as nvcc builds it: both branches
// contract to an fma
__device__ __forceinline__ float torch_lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? __fmaf_rn(w, __fsub_rn(end, self), self)
                         : __fmaf_rn(-__fsub_rn(end, self),
                                     __fsub_rn(1.0f, w), end);
}

__device__ __forceinline__ void adam_element(const AdamArgs& a, float decay,
                                             float step_size, float bc2,
                                             float& p, float g, float& m,
                                             float& v) {
  if (a.decoupled) p = __fmul_rn(p, decay);
  m = torch_lerp(m, g, a.lerp_weight);
  v = __fmaf_rn(a.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, a.beta2));
  float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2), a.eps);
  den = __fdiv_rn(den, step_size);
  p = __fadd_rn(p, __fdiv_rn(m, den));
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const AdamArgs a) {
  __shared__ float step_size[kMaxTensors];
  __shared__ float bc2[kMaxTensors];
  __shared__ bool last;

  const float lr = *a.lr;
  const float decay = __fsub_rn(1.0f, __fmul_rn(lr, a.weight_decay));
  for (int i = threadIdx.x; i < a.count; i += blockDim.x) {
    const float t = __fadd_rn(*a.step[i], 1.0f);
    step_size[i] =
        __fdiv_rn(1.0f, __fdiv_rn(__fsub_rn(powf(a.beta1, t), 1.0f), lr));
    bc2[i] = __fsqrt_rn(-__fsub_rn(powf(a.beta2, t), 1.0f));
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int i = 0; i < a.count; ++i) {
    const long long n = a.n[i];
    const long long units = (n + 3) >> 2;
    long long u = (tid - a.first[i]) % stride;  // this thread's first unit
    if (u < 0) u += stride;
    if (u >= units) continue;
    float* p = a.p[i];
    const float* g = a.g[i];
    float* m = a.m[i];
    float* v = a.v[i];
    const float ss = step_size[i], b2 = bc2[i];
    const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(m) |
                       reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    for (; u < units; u += stride) {
      const long long e = u << 2;
      if (vec && e + 4 <= n) {
        float4 pv = reinterpret_cast<float4*>(p)[u];
        const float4 gv = reinterpret_cast<const float4*>(g)[u];
        float4 mv = reinterpret_cast<float4*>(m)[u];
        float4 vv = reinterpret_cast<float4*>(v)[u];
        adam_element(a, decay, ss, b2, pv.x, gv.x, mv.x, vv.x);
        adam_element(a, decay, ss, b2, pv.y, gv.y, mv.y, vv.y);
        adam_element(a, decay, ss, b2, pv.z, gv.z, mv.z, vv.z);
        adam_element(a, decay, ss, b2, pv.w, gv.w, mv.w, vv.w);
        reinterpret_cast<float4*>(p)[u] = pv;
        reinterpret_cast<float4*>(m)[u] = mv;
        reinterpret_cast<float4*>(v)[u] = vv;
      } else {
        const long long end = e + 4 < n ? e + 4 : n;
        for (long long j = e; j < end; ++j) {
          float pj = p[j], mj = m[j], vj = v[j];
          adam_element(a, decay, ss, b2, pj, g[j], mj, vj);
          p[j] = pj;
          m[j] = mj;
          v[j] = vj;
        }
      }
    }
  }

  // every block has read the counts before it arrives here; the last to
  // arrive advances them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int i = threadIdx.x; i < a.count; i += blockDim.x) {
      *a.step[i] = __fadd_rn(*a.step[i], 1.0f);
    }
    if (threadIdx.x == 0) *a.done = 0u;
  }
}

}  // namespace

extern "C" {

// One Adam step over `count` float32 tensors, in place, on `stream` and the
// calling thread's current device; returns cudaGetLastError() of the first
// launch that failed, else 0.  p, g, m, v: each tensor's contiguous
// parameter, gradient and moments (n[i] elements each); step: its 0-dim
// float32 count; lr: a float32 on the device; done: an unsigned int on the
// device, zero between launches, which no other launch uses at the same
// time.  A list longer than kMaxTensors launches once a kMaxTensors.  Does
// not synchronise.
int border_adam_step(int count, void* const* p, void* const* g,
                     void* const* m, void* const* v, void* const* step,
                     const long long* n, const void* lr, float beta1,
                     float beta2, float lerp_weight, float one_minus_beta2,
                     float eps, float weight_decay, int decoupled, void* done,
                     void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int base = 0; base < count; base += kMaxTensors) {
    AdamArgs a;
    a.count = count - base < kMaxTensors ? count - base : kMaxTensors;
    long long units = 0;
    for (int i = 0; i < a.count; ++i) {
      a.p[i] = static_cast<float*>(p[base + i]);
      a.g[i] = static_cast<const float*>(g[base + i]);
      a.m[i] = static_cast<float*>(m[base + i]);
      a.v[i] = static_cast<float*>(v[base + i]);
      a.step[i] = static_cast<float*>(step[base + i]);
      a.n[i] = n[base + i];
      a.first[i] = units;
      units += (n[base + i] + 3) / 4;
    }
    a.lr = static_cast<const float*>(lr);
    a.done = static_cast<unsigned int*>(done);
    a.beta1 = beta1;
    a.beta2 = beta2;
    a.lerp_weight = lerp_weight;
    a.one_minus_beta2 = one_minus_beta2;
    a.eps = eps;
    a.weight_decay = weight_decay;
    a.decoupled = decoupled;
    const int threads =
        units >= kThreads ? kThreads
                          : static_cast<int>(units < 32 ? 32 : (units + 31) / 32 * 32);
    long long blocks = (units + threads - 1) / threads;
    const long long most = static_cast<long long>(sms) * kBlocksPerSm;
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;  // the counts advance even with no element
    adam_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int border_adam_max_tensors(void) { return kMaxTensors; }

const char* border_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The prioritized-replay sum tree's batched update and stratified descent,
// one launch each.
//
// Replaces no TPU kernel: border_tpu/replay/sum_tree.py is plain jnp, which
// XLA fuses into a few programs.  In PyTorch the same level loop costs a few
// small kernels a level over the tree's log2(capacity) levels (about 165
// launches an update and 160 a descent at 2^20 leaves), each a node of the
// trainer's CUDA graphs at a couple of microseconds apiece whatever its work.
// Here each operation walks every level inside one kernel.
//
// Layout (border_tpu_torch/replay/sum_tree.py): float32 sum and min trees of
// 2 * capacity entries, root at 1, leaf i at capacity + i, entry 0 unused.
//
// What bounds them on an H100: not bytes (an update of 512 leaves touches
// about 0.25 MB, a descent of 512 lanes reads about 82 KB) but the chain of
// log2(capacity) dependent levels, each a round trip to L2 or HBM.
//
// What the design does about it:
//  - the update is one block (up to 1024 threads, each taking every
//    blockDim-th index), so a __syncthreads orders one level's writes
//    before the next level's reads; the leaf write, the min leaves, the
//    running max priority and all parent levels happen in that one block;
//  - the descent is one thread a sample: one paired 8-byte read of a node's
//    two children a level.
//
// Both give the plain PyTorch loop's results bit for bit
// (border_tpu_torch/ops/sum_tree.py):
//  - a duplicated index keeps the maximum of the priorities written to it,
//    its old value taking no part: the written leaves are zeroed, then
//    atomicMax on the int bits, which order non-negative floats as the
//    floats (priorities are >= 0; a zero marks a dead leaf);
//  - a parent is sum[left] + sum[right] in that order, and the min tree's
//    min(left, right) propagates NaN as torch.minimum does;
//  - the descent's mass point is (i + u) * (total / B), each step rounded
//    to nearest (the intrinsics keep nvcc from contracting or
//    approximating), and it never enters a right subtree whose sum is zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSampleThreads = 128;

// torch.maximum / torch.minimum on floats: a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

__global__ void __launch_bounds__(kMaxThreads)
sum_tree_update_kernel(float* sum_tree, float* min_tree, float* max_priority,
                       const long long* __restrict__ idx, long long idx_stride,
                       const float* prio, long long prio_stride,
                       long long k, long long capacity, int depth) {
  __shared__ float warp_max[kMaxThreads / 32];
  const long long step = blockDim.x;

  for (long long i = threadIdx.x; i < k; i += step) {
    const long long leaf = idx[i * idx_stride];
    // an index outside [0, capacity) is a caller bug; stop the kernel as
    // PyTorch's own device-side index checks do
    if (leaf < 0 || leaf >= capacity) __trap();
    sum_tree[capacity + leaf] = 0.0f;
  }
  __syncthreads();

  // the leaves: the maximum written to each; and the batch's maximum.
  // Every read of prio (which may alias max_priority, stride 0) is done
  // before thread 0 writes max_priority at the end.
  float local_max = -INFINITY;
  for (long long i = threadIdx.x; i < k; i += step) {
    const float p = prio[i * prio_stride];
    atomicMax(reinterpret_cast<int*>(sum_tree + capacity + idx[i * idx_stride]),
              __float_as_int(p));
    local_max = nan_max(local_max, p);
  }
  __syncthreads();

  for (long long i = threadIdx.x; i < k; i += step) {
    const long long node = capacity + idx[i * idx_stride];
    const float p = __ldcg(sum_tree + node);
    min_tree[node] = p > 0.0f ? p : INFINITY;
  }

  // parents, a level at a time; threads that share a parent write the same
  // value, since a level's reads all come after the level below is written.
  // The block's own writes are read at L2 (__ldcg), where its stores and
  // atomics meet, so no line that L1 held from an earlier level is read
  for (int level = 1; level <= depth; ++level) {
    __syncthreads();
    for (long long i = threadIdx.x; i < k; i += step) {
      const long long node = (capacity + idx[i * idx_stride]) >> level;
      const long long left = 2 * node;
      sum_tree[node] =
          __fadd_rn(__ldcg(sum_tree + left), __ldcg(sum_tree + left + 1));
      min_tree[node] =
          nan_min(__ldcg(min_tree + left), __ldcg(min_tree + left + 1));
    }
  }

  // the running max priority, in place (captured graphs read its address)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local_max = nan_max(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      m = nan_max(m, warp_max[w]);
    }
    *max_priority = nan_max(*max_priority, m);
  }
}

__global__ void __launch_bounds__(kSampleThreads)
sum_tree_sample_kernel(const float* __restrict__ sum_tree,
                       const float* __restrict__ u, long long* __restrict__ out,
                       long long b, long long capacity, int depth) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const float stratum = __fdiv_rn(sum_tree[1], static_cast<float>(b));
  float mass = __fmul_rn(__fadd_rn(static_cast<float>(i), u[i]), stratum);
  // pairs[n] = (sum[2n], sum[2n + 1]): node n's two children
  const float2* pairs = reinterpret_cast<const float2*>(sum_tree);
  long long node = 1;
  for (int level = 0; level < depth; ++level) {
    const float2 lr = pairs[node];
    const bool go_right = mass >= lr.x && lr.y > 0.0f;
    node = 2 * node + (go_right ? 1 : 0);
    if (go_right) mass = __fsub_rn(mass, lr.x);
  }
  out[i] = node - capacity;
}

}  // namespace

extern "C" {

// The batched update of k leaves, in place, on `stream` and the calling
// thread's current device; returns cudaGetLastError().  indices: k int64
// at idx_stride elements apart; priorities: k float32 (>= 0) at
// prio_stride apart, which may be 0.  Does not synchronise.
int border_sum_tree_update(void* sum_tree, void* min_tree, void* max_priority,
                           const void* indices, long long idx_stride,
                           const void* priorities, long long prio_stride,
                           long long k, long long capacity, int depth,
                           void* stream) {
  if (k == 0) return 0;
  const long long warps = (k + 31) / 32;
  const int threads =
      static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  sum_tree_update_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(sum_tree), static_cast<float*>(min_tree),
      static_cast<float*>(max_priority),
      static_cast<const long long*>(indices), idx_stride,
      static_cast<const float*>(priorities), prio_stride, k, capacity, depth);
  return static_cast<int>(cudaGetLastError());
}

// The stratified descent of b lanes, u: b float32 draws in [0, 1), out: b
// int64 leaves; sum_tree 8-byte aligned.  As above otherwise.
int border_sum_tree_sample(const void* sum_tree, const void* u, void* out,
                           long long b, long long capacity, int depth,
                           void* stream) {
  if (b == 0) return 0;
  const long long blocks = (b + kSampleThreads - 1) / kSampleThreads;
  sum_tree_sample_kernel<<<static_cast<unsigned int>(blocks), kSampleThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sum_tree), static_cast<const float*>(u),
      static_cast<long long*>(out), b, capacity, depth);
  return static_cast<int>(cudaGetLastError());
}

const char* border_sum_tree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

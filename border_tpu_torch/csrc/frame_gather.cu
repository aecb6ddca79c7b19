// Frame-window gather for frame-dedup replay: out[b, s] = frames[idx[b, s]].
//
// Replaces border_tpu/ops/frame_gather.py::gather_frames (the Pallas kernel
// _gather_kernel, which issues one HBM->HBM DMA per (b, s) slot with the
// indices in scalar prefetch).
//
// What bounds it on an H100: HBM bytes.  It does no arithmetic; every output
// byte is one input byte read once and written once, so the least time is
// 2 * B * S * frame_bytes / (3.35 TB/s).  At the DQN-Pong sample shape
// (B = 512, S = 5, 84x84 uint8) that is 36.1 MB, about 10.8 us.  The
// measured times (chip_smoke.py) are in PERF.md.
//
// What the design does about it:
//  - one warp per (b, s) slot, four slots per 128-thread block, so a batch of
//    512 x 5 slots is 640 blocks spread over all SMs;
//  - each warp loads its own index (no prefetch stage is needed: the index
//    read is one 4-byte load ahead of a 7 KB copy);
//  - lanes copy the frame as 16-byte uint4 vectors, neighbouring lanes on
//    neighbouring addresses, four loads in flight per lane before the
//    matching stores, so each warp keeps 2 KB of reads outstanding;
//  - a byte path takes frames whose size or base address is not 16-aligned,
//    so any element type works: the kernel copies bytes.
// The TPU's (56, 128) tile padding is not copied: an 84x84 frame is 7056 B,
// already a multiple of 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gather_frames_kernel(const uint8_t* __restrict__ frames,
                     const int32_t* __restrict__ idx,
                     uint8_t* __restrict__ out,
                     long long m, long long frame_bytes, long long n_slots,
                     int vec16) {
  const int lane = threadIdx.x & 31;
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= n_slots) return;
  const long long row = idx[slot];
  // an index outside [0, m) is a caller bug; stop the kernel as PyTorch's
  // own device-side index checks do, rather than read outside the ring
  if (row < 0 || row >= m) __trap();
  const uint8_t* src = frames + row * frame_bytes;
  uint8_t* dst = out + slot * frame_bytes;

  if (vec16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long n = frame_bytes >> 4;
    long long i = lane;
    for (; i + 32 * (kUnroll - 1) < n; i += 32 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(s + i + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d[i + 32 * u] = v[u];
    }
    for (; i < n; i += 32) d[i] = __ldg(s + i);
  } else {
    for (long long i = lane; i < frame_bytes; i += 32) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// Launches the gather on `stream`, on the calling thread's current device
// (the wrapper sets it to the tensors' device); returns cudaGetLastError().
// frames: m frames of frame_bytes each; idx: n_slots int32; out: n_slots
// frames.  Does not synchronise.
int border_gather_frames(const void* frames, const void* idx, void* out,
                         long long m, long long frame_bytes,
                         long long n_slots, void* stream) {
  if (n_slots == 0 || frame_bytes == 0) return 0;
  const int vec16 = (frame_bytes % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(frames) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long blocks = (n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_frames_kernel<<<static_cast<unsigned int>(blocks), 32 * kWarpsPerBlock,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int32_t*>(idx),
      static_cast<uint8_t*>(out), m, frame_bytes, n_slots, vec16);
  return static_cast<int>(cudaGetLastError());
}

const char* border_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

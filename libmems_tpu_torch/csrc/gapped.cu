// K4: affine traceback walk, one thread per window.
//
// Replaces libmems_tpu/ops/gapped.py _device_tb_scan (a lax.scan of T
// lockstep steps over the whole batch, bit-packed with packbits for the
// transfer to the host).
//
// Bound: latency.  Each step of a walk reads one pointer byte whose
// address depends on the previous step, so a window costs up to
// T = 2(M+N)+4 dependent loads; the kernel moves 3 bytes per step and
// window.  Design: one thread per window, the state machine of
// ops/gapped.py:230-254, stopping when the walk reaches (0, 0); the
// caller zero-fills the masks, so a finished walk writes nothing more.
// Masks are laid out [T, B] so a warp's stores of one step are
// contiguous.  The TPU's packbits is dropped: the host reads bool masks.
#include "common.cuh"

namespace {

constexpr unsigned char kEExt = 4, kFExt = 8;

__global__ void traceback_kernel(const unsigned char* __restrict__ ptr,
                                 const int* __restrict__ p_len,
                                 const int* __restrict__ q_len, int B, int M,
                                 int N, int T, unsigned char* __restrict__ steps,
                                 unsigned char* __restrict__ agaps,
                                 unsigned char* __restrict__ bgaps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t n1 = N + 1;
  const unsigned char* pb = ptr + (int64_t)b * M * n1;
  int i = p_len[b];
  int j = q_len[b];
  int st = 0;
  for (int t = 0; t < T; ++t) {
    if (i <= 0 && j <= 0) break;
    const bool c0 = i == 0;
    const bool c1 = i > 0 && j == 0;
    const bool c2 = i > 0 && j > 0;
    const int byte = c2 ? pb[(int64_t)(i - 1) * n1 + j] : 0;
    const bool was_h = c2 && st == 0;
    const bool was_e = c2 && st == 1;
    const bool was_f = c2 && st == 2;
    const int newst = byte & 3;
    const bool dm = was_h && newst == 0;
    const int64_t o = (int64_t)t * B + b;
    steps[o] = (c0 || c1 || dm || was_e || was_f) ? 1 : 0;
    agaps[o] = (c0 || was_e) ? 1 : 0;
    bgaps[o] = (c1 || was_f) ? 1 : 0;
    i -= (c1 || dm || was_f) ? 1 : 0;
    j -= (c0 || dm || was_e) ? 1 : 0;
    if (was_h) {
      st = newst;
    } else if (was_e) {
      st = (byte & kEExt) ? 1 : 0;
    } else if (was_f) {
      st = (byte & kFExt) ? 2 : 0;
    }
  }
}

}  // namespace

// ptr: uint8[B, M, N+1]; p_len, q_len: int32[B];
// steps, agaps, bgaps: uint8[T, B], zero-filled by the caller.
extern "C" int lm_traceback(const void* ptr, const void* p_len,
                            const void* q_len, int B, int M, int N, int T,
                            void* steps, void* agaps, void* bgaps,
                            void* stream) {
  if (B > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    LM_LAUNCH(traceback_kernel, blocks, threads, 0, (cudaStream_t)stream,
              (const unsigned char*)ptr, (const int*)p_len,
              (const int*)q_len, B, M, N, T, (unsigned char*)steps,
              (unsigned char*)agaps, (unsigned char*)bgaps);
  }
  return (int)cudaGetLastError();
}

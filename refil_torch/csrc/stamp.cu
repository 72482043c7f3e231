// Device stamps for the fused pipeline's block (core/pipeline.py).
//
// Replaces no TPU kernel: the JAX package's block is one XLA program with no
// clock inside it. A CUDA graph of a block holds ~123k kernels, and a host
// clock can time only the whole replay; these stamps time its stages on the
// device.
//
// stamp_kernel is one thread that writes %globaltimer (the card's global
// nanosecond timer) into one slot of an int64 buffer. The pipeline calls it
// at each stage boundary of a block, each call with its own slot, so a
// captured graph holds the calls with their slots and every replay rewrites
// the same slots. It moves 8 bytes and waits on the kernel before it in the
// stream, as every kernel does: its cost is a launch, ~2 us of device time.
//
// Interface: plain C (extern "C"), loaded with ctypes; the wrapper
// (ops/stamp.py) owns the buffer, the launcher enqueues on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(int64_t* buf, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = (int64_t)t;
}

}  // namespace

extern "C" {

int stamp_write(int64_t* buf, int slot, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(buf, slot);
  return (int)cudaGetLastError();
}

const char* stamp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

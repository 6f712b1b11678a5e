// An empty kernel: the least time one launch of the port takes on the card.
//
// No counterpart in gen_tpu. ops/launch_floor.py launches it through the
// same ctypes path as K4 and K5 (a torch.empty output, the current stream),
// so that chip_smoke.py and layout_timing.py can set the small kernels'
// times beside the time of a launch that does no work. It lies on no path
// of the system.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void launch_floor_kernel(int32_t* out) {}

extern "C" int launch_floor(void* out, void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

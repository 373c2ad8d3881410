// Layer marks for traces of the port (procgen2_tpu_torch/utils/trace.py).
//
// One empty kernel per layer, `trace_mark_<layer>`, launched as one thread
// on the caller's stream. It does no work: its launch is a named point on
// the device's timeline. Under a CUDA graph's capture it becomes a kernel
// node, so a profiled replay shows, in time order, each layer's mark
// followed by that layer's kernels. The names are unmangled (extern "C"),
// as the readers of a trace look for them.
//
// Plain C entry points (bound with ctypes): trace_mark_<layer>_launch(stream)
// launches the mark and returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#define TRACE_MARK(layer)                                              \
  extern "C" __global__ void trace_mark_##layer() {}                   \
  extern "C" int trace_mark_##layer##_launch(void* stream) {           \
    trace_mark_##layer<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(); \
    return static_cast<int>(cudaGetLastError());                       \
  }

TRACE_MARK(actions)
TRACE_MARK(game_step)
TRACE_MARK(auto_reset)
TRACE_MARK(render)
TRACE_MARK(stack)
TRACE_MARK(end)

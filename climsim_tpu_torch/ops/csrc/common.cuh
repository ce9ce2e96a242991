// Shared declarations of the serving kernels (plain C interface, built by
// ops/_build.py into one shared library and called through ctypes).
//
// Every extern "C" entry launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() right after
// the launch, so a launch the runtime refuses is reported to the caller.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cst {

// Most layers one fused-MLP launch takes (the coupling MLP has 5).
constexpr int kMaxLayers = 16;

// Layer widths (d_in, h_1, ..., d_out), passed to the kernel by value.
struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];
};

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a launch is refused unless the
// kernel opts in.  The opt-in is a host call of a few microseconds, so it
// is made once per kernel and device, to the card's whole limit; each
// launch still asks only for what it needs.
template <typename Kernel>
int opt_in_shared_memory(Kernel kernel, bool (&done)[kMaxDevices],
                         std::mutex& mu) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return 0;
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  done[dev] = true;
  return 0;
}

}  // namespace cst

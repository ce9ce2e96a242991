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

namespace cst {

// Most layers one fused-MLP launch takes (the coupling MLP has 5).
constexpr int kMaxLayers = 16;

// Layer widths (d_in, h_1, ..., d_out), passed to the kernel by value.
struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];
};

}  // namespace cst

// SmemOnce, shared by tc_gemm.cuh (vector_attention.cu, vit_block.cu) and
// fps.cu; each translation unit's own copy (an unnamed namespace).

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

// A kernel's dynamic shared memory limit raised to smem bytes once a device:
// setting the attribute is a CUDA API call that costs host time on every launch
// otherwise. One SmemOnce for each kernel (a static of the function that
// launches it), smem the most that kernel is ever launched with.
struct SmemOnce {
  std::atomic<unsigned long long> done{0};  // a bit a device
  template <class Kernel>
  int operator()(Kernel kernel, size_t smem) {
    int dev = 0;
    int err = cudaGetDevice(&dev);
    if (err) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (done.load() & bit) return 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (!err) done.fetch_or(bit);
    return err;
  }
};

}  // namespace

// The physics control step as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel metaworld_tpu/physics/pallas_step.py
// (_make_kernel -> _step_kernel_v0..v3, launched by control_step): FRAME_SKIP
// substeps of the lane engine per env, reading the packed state rows once
// and writing them once.
//
// Design: one thread per env, one launch per control step. The state keeps
// the packed (SIM_ROWS, N) row layout, so thread i reads row r at r*N + i
// and a warp's loads and stores coalesce. Per env and control step that is
// 63 state floats in, 63 out, 4 control floats and one task id: about 524
// bytes, against a few thousand float32 operations, so the kernel is bound
// by operations, not bytes.
//
// Each 128-thread block reads its row of the block table
// (cuda_step.block_table): which variant its envs need, which envs, which
// task ids. The row is uniform across the block, so the `switch` to the
// variant's template instantiation (block_step.cuh) does not diverge. On a
// TPU the Pallas grid runs in order on one core, so the JAX package launches
// one switch-free kernel per same-variant run; here the blocks of all four
// variants share the 132 SMs of one launch, and the table lists the
// heaviest variant first so its blocks start first and do not form the
// tail.
//
// Exports a plain C interface loaded with ctypes. The build passes
// --fmad=false so the kernel rounds as its plain PyTorch version does
// (physics/_build.py).
#include <cuda_runtime.h>

#include "block_step.cuh"

// Blocks per SM the register budget is chosen for (__launch_bounds__).
// One kernel carries all four variants, so ptxas allocates for the
// heaviest branch: 193 registers and 2 blocks per SM uncapped. Capped at
// 128 registers for 4 blocks it spills under 1 KB per thread and ran
// fastest on the H100, ahead of 3 blocks (168 registers) and 2 (PERF.md;
// metaworld_tpu_torch/kernel_sweep.py overrides this to measure).
#ifndef MW_MIN_BLOCKS
#define MW_MIN_BLOCKS 4
#endif

namespace {

constexpr int kThreads = 128;  // cuda_step.BLOCK

__global__ void __launch_bounds__(kThreads, MW_MIN_BLOCKS)
step_kernel(const int* __restrict__ blocks, const float* __restrict__ table,
            const int* __restrict__ task_ids, const float* __restrict__ state_in,
            const float* __restrict__ ctl, float* __restrict__ state_out, int n) {
  const mw::BlockRow blk = mw::block_row(blocks, blockIdx.x);
  mw::step_env(blk, table, task_ids, state_in, ctl, state_out, n, threadIdx.x);
}

}  // namespace

// One launch over the `n_blocks` rows of the block table, on `stream`;
// returns cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int mw_step(const int* blocks, int n_blocks, const float* table,
                       const int* task_ids, const float* state_in, const float* ctl,
                       float* state_out, int n, void* stream) {
  if (n_blocks <= 0) return 0;
  step_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, table, task_ids, state_in, ctl, state_out, n);
  return static_cast<int>(cudaGetLastError());
}

// The kernel as built: registers, local (stack and spill) bytes and static
// shared bytes per thread block, and the blocks an SM holds at once.
extern "C" int mw_step_info(int* regs, int* local_bytes, int* shared_bytes,
                            int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, step_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *shared_bytes = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, step_kernel, kThreads, 0));
}

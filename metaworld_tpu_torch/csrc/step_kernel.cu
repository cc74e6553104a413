// The physics control step as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel metaworld_tpu/physics/pallas_step.py
// (_make_kernel -> _step_kernel_v0..v3, launched by control_step): FRAME_SKIP
// substeps of the lane engine per env, reading the packed state rows once
// and writing them once.
//
// Design: one thread per env. The state keeps the packed (SIM_ROWS, N) row
// layout, so thread i reads row r at r*N + i and a warp's loads and stores
// coalesce. Scene rows are identical across a task's slots, so the scene is
// an (n_tasks, SC_ROWS) table indexed by a per-slot task id: a warp mostly
// reads one task's row and the reads broadcast from L1. Per env and control
// step that is 63 state floats in, 63 out, 4 control floats and one task id:
// about 524 bytes. The substep is long branch-free float arithmetic (a few
// thousand operations per env per control step), so the kernel is bound by
// operations, not bytes; the four template instantiations drop the feature
// families a block of envs does not have (see cuda_step.block_variants),
// which is what the Pallas build did per block.
//
// Built once per variant (-DMW_VARIANT=0..3) so the four objects compile in
// parallel; each exports mw_step_v<variant> with a plain C interface. The
// build passes --fmad=false so the kernel rounds as its plain PyTorch
// version does (physics/_build.py).
#include <cuda_runtime.h>

#include "substep.cuh"

#ifndef MW_VARIANT
#error "define MW_VARIANT (0..3)"
#endif

#define MW_CAT2(a, b) a##b
#define MW_CAT(a, b) MW_CAT2(a, b)

namespace {

constexpr int kThreads = 128;

#if MW_VARIANT == 0
constexpr bool kObj = true, kJoint = false, kBox = false;
#elif MW_VARIANT == 1
constexpr bool kObj = true, kJoint = false, kBox = true;
#elif MW_VARIANT == 2
constexpr bool kObj = false, kJoint = true, kBox = true;
#else
constexpr bool kObj = true, kJoint = true, kBox = true;
#endif

__global__ void __launch_bounds__(kThreads)
MW_CAT(step_kernel_v, MW_VARIANT)(const float* __restrict__ table,
                                  const int* __restrict__ task_ids,
                                  const float* __restrict__ state_in,
                                  const float* __restrict__ ctl,
                                  float* __restrict__ state_out,
                                  int n, int start, int count) {
  int i = start + blockIdx.x * kThreads + threadIdx.x;
  if (i >= start + count) return;
  mw::Scene sc{table + static_cast<long>(__ldg(task_ids + i)) * mw::SC_ROWS};
  mw::State s = mw::load_state(state_in, n, i);
  mw::V3 target{ctl[i], ctl[n + i], ctl[2 * n + i]};
  float effort = ctl[3 * n + i];
  s = mw::control_substeps<kObj, kJoint, kBox>(sc, s, target, effort);
  mw::store_state(state_out, n, i, s);
}

}  // namespace

// Launch over envs [start, start + count) on `stream`; returns
// cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int MW_CAT(mw_step_v, MW_VARIANT)(const float* table, const int* task_ids,
                                            const float* state_in, const float* ctl,
                                            float* state_out, int n, int start, int count,
                                            void* stream) {
  if (count <= 0) return 0;
  int blocks = (count + kThreads - 1) / kThreads;
  MW_CAT(step_kernel_v, MW_VARIANT)<<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      table, task_ids, state_in, ctl, state_out, n, start, count);
  return static_cast<int>(cudaGetLastError());
}

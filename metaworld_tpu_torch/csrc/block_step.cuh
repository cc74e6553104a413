// One block of the physics control step: read the block's row of the block
// table and run one env's FRAME_SKIP substeps in the variant the row names.
//
// __host__ __device__ so the CUDA kernel (step_kernel.cu, one thread per
// env) and its host build (host_step.cpp, one env after another) walk the
// block table through the same code. The table is built by
// physics/cuda_step.py::block_table.
#pragma once

#include "substep.cuh"

namespace mw {

// Columns of one block-table row (cuda_step.BLOCK_COLS).
enum BlockCol : int {
  B_VARIANT = 0, B_FIRST_ENV = 1, B_COUNT = 2, B_FIRST_TASK = 3, B_N_TASKS = 4,
  BLOCK_COLS = 5
};

struct BlockRow {
  int variant;    // 0..3: which feature families the block's envs need
  int first_env;  // the block runs envs [first_env, first_env + count)
  int count;
};

MW_HDI BlockRow block_row(const int* rows, int b) {
  const int* r = rows + b * BLOCK_COLS;
  return {r[B_VARIANT], r[B_FIRST_ENV], r[B_COUNT]};
}

// The control step of the block's env `t` (nothing when t >= count): its
// task's row of the (n_tasks, SC_ROWS) scene table, the state and control
// from the packed (rows, n) tensors. Variant 3 (and any other id) runs
// every feature.
MW_HDI void step_env(const BlockRow& blk, const float* table, const int* task_ids,
                     const float* state_in, const float* ctl, float* state_out,
                     int n, int t) {
  if (t >= blk.count) return;
  int i = blk.first_env + t;
  Scene sc{table + task_ids[i] * SC_ROWS};
  State s = load_state(state_in, n, i);
  V3 target{ctl[i], ctl[n + i], ctl[2 * n + i]};
  float effort = ctl[3 * n + i];
  switch (blk.variant) {
    case 0: s = control_substeps<true, false, false>(sc, s, target, effort); break;
    case 1: s = control_substeps<true, false, true>(sc, s, target, effort); break;
    case 2: s = control_substeps<false, true, true>(sc, s, target, effort); break;
    default: s = control_substeps<true, true, true>(sc, s, target, effort); break;
  }
  store_state(state_out, n, i, s);
}

}  // namespace mw

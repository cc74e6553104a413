// Host build of the physics substep (test-only).
//
// Runs the same templated substep as the CUDA kernel (substep.cuh) on the
// CPU, one env after another, through the same packed-row interface as
// step_kernel.cu, so the kernel's arithmetic can be held against the
// PyTorch lane engine on a machine without a GPU. Built with g++ by
// physics/_build.py::build_host; the engine never calls it.
#include "substep.cuh"

namespace {

template <bool O, bool J, bool H>
void run(const float* table, const int* task_ids, const float* state_in,
         const float* ctl, float* state_out, int n, int start, int count) {
  for (int i = start; i < start + count; ++i) {
    mw::Scene sc{table + static_cast<long>(task_ids[i]) * mw::SC_ROWS};
    mw::State s = mw::load_state(state_in, n, i);
    mw::V3 target{ctl[i], ctl[n + i], ctl[2 * n + i]};
    float effort = ctl[3 * n + i];
    s = mw::control_substeps<O, J, H>(sc, s, target, effort);
    mw::store_state(state_out, n, i, s);
  }
}

}  // namespace

extern "C" int mw_host_step(int variant, const float* table, const int* task_ids,
                            const float* state_in, const float* ctl,
                            float* state_out, int n, int start, int count) {
  switch (variant) {
    case 0: run<true, false, false>(table, task_ids, state_in, ctl, state_out, n, start, count); return 0;
    case 1: run<true, false, true>(table, task_ids, state_in, ctl, state_out, n, start, count); return 0;
    case 2: run<false, true, true>(table, task_ids, state_in, ctl, state_out, n, start, count); return 0;
    case 3: run<true, true, true>(table, task_ids, state_in, ctl, state_out, n, start, count); return 0;
    default: return 1;
  }
}

extern "C" int mw_layout(int* sc_rows, int* sim_rows) {
  *sc_rows = mw::SC_ROWS;
  *sim_rows = mw::SIM_ROWS;
  return 0;
}

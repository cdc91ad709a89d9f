// The bf16 block compute of pm_mppi.cu (compute_dtype "bfloat16" of
// mppi_tf_tpu/kernels/pm_mppi.py): the same source at Val = bf16x2, two
// samples a thread in native bf16x2 arithmetic (MPPI_BF16_PAIRS), its
// kernels and entry points suffixed _bf16 (mppi_common.cuh). A
// translation unit of its own, so that nvcc builds it beside the f32 one.
#define MPPI_BF16
#define MPPI_BF16_PAIRS
#define MPPI_SUFFIX _bf16
#include "pm_mppi.cu"

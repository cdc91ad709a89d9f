// nn_mppi.cu for a model whose compute_dtype is bf16, run by the f32
// kernel: bf16 products with f32 accumulation over unfolded normalisers,
// as the JAX XLA path computes that model (nn_mppi.cu's notes). Kernels
// and entry points suffixed _bfp; a translation unit of its own.
#define MPPI_NN_BF16_PRODUCTS
#define MPPI_SUFFIX _bfp
#include "nn_mppi.cu"

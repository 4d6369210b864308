// The roofline calibration chains for Hopper (sm_90a).
//
// Replaces scripts/calibrate_roofline.py::_chain_kernel (:48-58, launched by
// `build`, pl.pallas_call at :66). Each thread holds NCHAIN = 4 independent
// float32 chains in registers; chain k starts at x * init[k] and applies
//     v = fmaf(core(v, c[k]), a[k], b[k])
// DEPTH = 16 times per loop iteration, `iters` iterations, then writes its
// chains out so that no work is dead. The per-chain constants (computed on
// the host by rtwc_tpu_torch/utils/calibrate.py from c = 1 + 1e-4 k, as JAX's
// bodies compute them) keep the chains from being merged, and each body's
// stabilising multiply-add keeps its value in the op's domain forever. The
// bodies are JAX's twelve (calibrate_roofline.py:103-120) plus log1p, each in
// the form the port's soft kernels run (csrc/soft_common.cuh): IEEE sqrtf and
// division, expf / logf / log1pf / tanhf without fast math, 1 / sqrtf for
// rsqrt.
//
// What bounds it, and the design. The chains measure instruction throughput, not
// latency: four independent chains a thread, 256-thread blocks, and a grid
// the wrapper sizes to fill every SM at full occupancy (SMs x 2048 threads),
// so each scheduler always has an independent instruction ready. A pure
// FMA chain is then bound by the FP32 pipes (128 lanes an SM a clock); the
// timing harness takes the slope between two iteration counts, which removes
// the launch and the load / store of the chains. The library is built with
// -fmad=false like every other, so the stabiliser is an explicit __fmaf_rn:
// an `x * a + b` would compile to a multiply and an add, and the measured
// mul / add weights are then the costs the soft kernels pay.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NCHAIN = 4;
constexpr int DEPTH = 16;

// Body ids, in the order of rtwc_tpu_torch/utils/calibrate.py OPS.
enum Op {
  FMA = 0, MUL, ADD, MAX, ABS, SELECT, EXP, LOG, LOG1P, RSQRT, SQRT, DIV, LOGISTIC, TANH,
  N_OPS
};

template <int OP>
__device__ __forceinline__ float core(float x, float c) {
  if constexpr (OP == MUL) return x * c;
  else if constexpr (OP == ADD) return x + c;
  else if constexpr (OP == MAX) return fmaxf(x, c);
  else if constexpr (OP == ABS) return fabsf(x);
  else if constexpr (OP == SELECT) return x > 0.5f ? x : c;
  else if constexpr (OP == EXP) return expf(x);
  else if constexpr (OP == LOG) return logf(x);
  else if constexpr (OP == LOG1P) return log1pf(x);
  else if constexpr (OP == RSQRT) return 1.0f / sqrtf(x);
  else if constexpr (OP == SQRT) return sqrtf(x);
  else if constexpr (OP == DIV) return c / x;
  else if constexpr (OP == LOGISTIC) return 1.0f / (1.0f + expf(-x));
  else if constexpr (OP == TANH) return tanhf(x);
  else return x;  // FMA: the stabiliser alone
}

}  // namespace

// The launch; declared with ctypes in rtwc_tpu_torch/utils/calibrate.py.
struct ChainParams {
  int op;     // Op
  int n;      // elements of x (one thread each)
  int iters;  // loop iterations, DEPTH applications each
  int device;
  float init[NCHAIN];  // chain k starts at x * init[k]
  float c[NCHAIN];     // core's constant
  float a[NCHAIN];     // stabiliser: v = fmaf(core, a, b)
  float b[NCHAIN];
};

template <int OP>
__global__ void __launch_bounds__(256) chain_kernel(ChainParams p, const float* __restrict__ x,
                                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float xi = x[i];
  float v[NCHAIN], c[NCHAIN], a[NCHAIN], b[NCHAIN];
#pragma unroll
  for (int k = 0; k < NCHAIN; ++k) {
    v[k] = xi * p.init[k];
    c[k] = p.c[k];
    a[k] = p.a[k];
    b[k] = p.b[k];
  }
  for (int it = 0; it < p.iters; ++it) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
      for (int k = 0; k < NCHAIN; ++k) v[k] = __fmaf_rn(core<OP>(v[k], c[k]), a[k], b[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < NCHAIN; ++k) out[(size_t)k * p.n + i] = v[k];
}

template <int OP>
static void launch(const ChainParams& p, const float* x, float* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (p.n + threads - 1) / threads;
  chain_kernel<OP><<<blocks, threads, 0, stream>>>(p, x, out);
}

// C entry for ctypes: x [n] and out [NCHAIN, n] are device pointers of
// contiguous float32 tensors the wrapper has checked; `stream` is PyTorch's
// current stream. Returns the cudaError_t of the launch (0 on success). Does
// not synchronise.
extern "C" int rtwc_chain(const float* x, float* out, const ChainParams* params, void* stream) {
  const ChainParams p = *params;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  if (p.n <= 0 || p.iters < 0 || p.op < 0 || p.op >= N_OPS) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.op) {
    case FMA: launch<FMA>(p, x, out, s); break;
    case MUL: launch<MUL>(p, x, out, s); break;
    case ADD: launch<ADD>(p, x, out, s); break;
    case MAX: launch<MAX>(p, x, out, s); break;
    case ABS: launch<ABS>(p, x, out, s); break;
    case SELECT: launch<SELECT>(p, x, out, s); break;
    case EXP: launch<EXP>(p, x, out, s); break;
    case LOG: launch<LOG>(p, x, out, s); break;
    case LOG1P: launch<LOG1P>(p, x, out, s); break;
    case RSQRT: launch<RSQRT>(p, x, out, s); break;
    case SQRT: launch<SQRT>(p, x, out, s); break;
    case DIV: launch<DIV>(p, x, out, s); break;
    case LOGISTIC: launch<LOGISTIC>(p, x, out, s); break;
    case TANH: launch<TANH>(p, x, out, s); break;
  }
  return (int)cudaGetLastError();
}

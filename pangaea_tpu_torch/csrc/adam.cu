// One Adam step with torch's coupled L2 over every parameter of a model, in
// one launch, for sm_90a: bit for bit the step of eager torch.optim.Adam
// (foreach, weight_decay > 0, no amsgrad, not maximize) on a CUDA card.
//
// Replaces no TPU kernel: pangaea_tpu steps Adam with optax inside its
// jitted unit, and XLA fuses it. It exists so that step 2's fused unit can
// be captured as one CUDA graph (model/train.py): eager Adam computes its
// bias corrections on the host, one step at a time, so a captured eager step
// would replay one step's scalars forever. This kernel reads them from a
// device table through a device step counter that it advances itself.
//
// Semantics, per element, in the order and rounding of
// torch.optim.adam._multi_tensor_adam's foreach calls (each foreach
// functor computes in float32 and nvcc contracts a product and a sum of
// one expression into one fma):
//   g  = fma(wd, p, g)                  _foreach_add(grads, params, alpha=wd)
//   m  = fma(1-b1, g - m, m)            _foreach_lerp_(exp_avgs, g, 1-b1)
//   v  = v * b2                         _foreach_mul_(exp_avg_sqs, b2)
//   v  = fma(1-b2, g * g, v)            _foreach_addcmul_(exp_avg_sqs, g, g, 1-b2)
//   d  = sqrt(v) / bc2_sqrt + eps       _foreach_sqrt, _foreach_div_, _foreach_add_
//   p  = fma(step_size, m / d, p)       _foreach_addcdiv_(params, m, d, step_size)
// with step_size = -lr / (1 - b1^t) and bc2_sqrt = (1 - b2^t) ** 0.5 of step
// t computed on the host in float64 and rounded to float32, as the foreach
// kernels round a Python scalar (kernels/adam.py builds the table). Every
// operation is written with an _rn intrinsic, so the compiler can neither
// contract nor reassociate it differently from the foreach kernels.
//
// Bound: memory. Per element it reads p, g, m, v and writes p, m, v: 28
// bytes. The VAE of step 2 at its defaults has 1.12 M parameters, 31 MB, so
// about 9.4 us at 3.35 TB/s. The eager step launches 8 foreach kernels (more
// where a list spans several launches) that read and write about 84 bytes
// an element, and its host work takes far longer than either (PERF.md §6).
//
// Design:
//  1. The tensors travel by value in the kernel's parameters (pointers and
//     sizes, as PyTorch's multi_tensor_apply passes them), so a captured
//     launch keeps the addresses it was captured with and needs no device
//     table of pointers. Up to kMaxTensors tensors go in one launch; more
//     take several launches, and only the last one advances the counter.
//  2. Each block owns one chunk of kChunk elements of one tensor; the block
//     finds its tensor in the prefix of block counts by a short linear scan.
//     Threads take consecutive elements, so every access is coalesced.
//  3. The step counter: state[0] is the number of steps taken, state[1] a
//     count of finished blocks. Thread 0 of each block reads the step's row
//     (rows[state[0]]) before the block works. When a block is done, thread
//     0 adds one to state[1]; the block that finds it was the last one (every
//     other block has read its row by then) resets state[1] and advances
//     state[0]. The next launch on the stream sees both.
//  4. A step past the table's `nrows` rows changes nothing: every block of
//     the launch reads the same state[0], finds it out of range, sets
//     state[2] (the error flag, which the host reads once a fit is done)
//     and returns before touching a tensor or the counter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 8;

struct Tensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  int block_start[kMaxTensors + 1];
  int count;
};

struct Consts {
  float wd;     // weight_decay
  float w1;     // 1 - beta1, the lerp's weight
  float b2;     // beta2
  float c2;     // 1 - beta2, addcmul's value
  float eps;
  int has_wd;   // eager skips the decay when weight_decay == 0
  int advance;  // this launch advances the step counter
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(Tensors t, Consts c, const float2* __restrict__ rows,
            int nrows, int* state) {
  __shared__ float2 row;
  __shared__ int in_range;
  if (threadIdx.x == 0) {
    const int step = *(volatile int*)state;
    in_range = step >= 0 && step < nrows;
    if (in_range)
      row = rows[step];
    else
      state[2] = 1;
  }
  __syncthreads();
  if (!in_range) return;
  const float step_size = row.x, bc2_sqrt = row.y;

  const int b = blockIdx.x;
  int k = 0;
  while (b >= t.block_start[k + 1]) ++k;
  const long long base = (long long)(b - t.block_start[k]) * kChunk;
  const long long end = min(base + kChunk, t.n[k]);
  float* __restrict__ p = t.p[k];
  const float* __restrict__ g = t.g[k];
  float* __restrict__ m = t.m[k];
  float* __restrict__ v = t.v[k];
  for (long long i = base + threadIdx.x; i < end; i += kThreads) {
    const float pi = p[i];
    float gi = g[i];
    if (c.has_wd) gi = __fmaf_rn(c.wd, pi, gi);
    const float mi = __fmaf_rn(c.w1, __fsub_rn(gi, m[i]), m[i]);
    float vi = __fmul_rn(v[i], c.b2);
    vi = __fmaf_rn(c.c2, __fmul_rn(gi, gi), vi);
    const float d =
        __fadd_rn(__fdiv_rn(__fsqrt_rn(vi), bc2_sqrt), c.eps);
    m[i] = mi;
    v[i] = vi;
    p[i] = __fmaf_rn(step_size, __fdiv_rn(mi, d), pi);
  }

  if (!c.advance) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&state[1], 1) == (int)gridDim.x - 1) {
      state[1] = 0;
      state[0] += 1;
    }
  }
}

}  // namespace

extern "C" {

// One Adam step over `count` float32 tensors. `ptrs` holds 4 * count
// device pointers (param, grad, exp_avg, exp_avg_sq of each tensor in
// turn), `numel` their sizes. `rows` is the device table of `nrows`
// (step_size, bc2_sqrt) float32 pairs, one per step; `state` three device
// int32 (steps taken, blocks finished: 0 between launches, and the flag of
// a step past the table). Launches on `stream` and returns
// cudaGetLastError() of the last launch (0 on success).
int pga_adam_step(int count, const uint64_t* ptrs, const long long* numel,
                  float wd, float w1, float b2, float c2, float eps,
                  int has_wd, const void* rows, int nrows, void* state,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int last = 0;  // the last group that has any element advances the counter
  for (int i = 0; i < count; ++i)
    if (numel[i] > 0) last = i / kMaxTensors;
  for (int first = 0, grp = 0; first < count; first += kMaxTensors, ++grp) {
    Tensors t;
    t.count = 0;
    t.block_start[0] = 0;
    for (int i = first; i < count && i < first + kMaxTensors; ++i) {
      if (numel[i] <= 0) continue;
      const int j = t.count++;
      t.p[j] = reinterpret_cast<float*>(ptrs[4 * i]);
      t.g[j] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
      t.m[j] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
      t.v[j] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
      t.n[j] = numel[i];
      t.block_start[j + 1] =
          t.block_start[j] + (int)((numel[i] + kChunk - 1) / kChunk);
    }
    if (t.count == 0) continue;
    Consts c{wd, w1, b2, c2, eps, has_wd, grp == last};
    adam_kernel<<<t.block_start[t.count], kThreads, 0, s>>>(
        t, c, static_cast<const float2*>(rows), nrows,
        static_cast<int*>(state));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"

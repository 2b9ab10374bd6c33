// Ragged paged attention: the single-token decode read over a paged KV
// cache, written by hand for Hopper (sm_90a).
//
// Replaces: tensorframes_tpu/ops/attention.py::_ragged_paged_kernel, the
// Pallas TPU kernel behind ragged_paged_attention (grid = slots x kv_heads
// x max_pages, the page axis sequential with the online-softmax state
// carried in VMEM scratch from one grid step to the next).
//
// What it computes, for every slot s and kv head h:
//   out[s, h, g, :] = softmax(q[s, h, g, :] . K^T / sqrt(hd)) . V
// over positions [0, lengths[s]), where position t lives at row t % ps of
// page page_table[s, t / ps] of the pool [pages, ps, n_kv, hd].
//
// Design. Blocks run in parallel and in no order on this card, so the
// TPU's sequential page axis becomes a loop inside one block, and one
// block serves one (slot, kv head). The block reads its own page-table row
// and length (the TPU kernel's scalar prefetch). For each LIVE page only it
// stages the [ps, hd] K and V tiles in shared memory (as f32), scores the
// `group` query rows that share this kv head in f32 (scaled by
// scale * log2(e), as online_block_update does), masks positions >= length
// with _NEG_BIG on the boundary page only, and folds the page into the
// running max / normalizer / accumulator with exp2. Pages past the length
// are never loaded (the TPU kernel still fetched a trash tile for them).
// The final output is acc / max(l, 1e-30) in the input dtype.
//
// Bound: the kernel must read every live K and V row once:
//   bytes = sum_s live_tokens_s * n_kv * hd * elt_size * 2
// (plus q, out, the page table and lengths, which are small), so it is
// bound by device memory: bytes / 3.35 TB/s on an H100 SXM. The
// arithmetic (4 * group * hd flops per live token and head) is far below
// the card's compute rates.
//
// Known limit: slots * n_kv blocks, 16 * 2 = 32 at the serving slice's
// shapes, which underfills the card's 132 SMs; each block also walks its
// pages one at a time with no load/compute overlap. Split-K over pages
// plus a combine pass, and cp.async double buffering, are later work.
//
// Supported: f32 and bf16 inputs (f32 accumulation), head_dim 64 or 128,
// page_size and group bounded by the shared memory the launcher reports.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -0.7 * FLT_MAX: exp2(_NEG_BIG - m) underflows to exactly 0
constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared-memory floats for one block; K rows are padded by one float so
// the threads of a warp (one key row each) hit different banks
__host__ __device__ inline size_t smem_floats(int group, int hd, int ps) {
  return (size_t)group * hd          // q rows
         + (size_t)ps * (hd + 1)     // K tile, padded
         + (size_t)ps * hd           // V tile
         + (size_t)group * ps        // scores, then probabilities
         + (size_t)group * hd        // accumulator
         + 3 * (size_t)group;        // m, l, alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q,                 // [S, n_kv, group, HD]
    const T* __restrict__ k_pages,           // [P, ps, n_kv, HD]
    const T* __restrict__ v_pages,           // [P, ps, n_kv, HD]
    const int32_t* __restrict__ page_table,  // [S, max_pages]
    const int32_t* __restrict__ lengths,     // [S]
    T* __restrict__ out,                     // [S, n_kv, group, HD]
    int n_kv, int group, int page_size, int max_pages, float qk_scale_log2) {
  extern __shared__ float smem[];
  constexpr int KP = HD + 1;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  float* q_s = smem;
  float* k_s = q_s + group * HD;
  float* v_s = k_s + page_size * KP;
  float* p_s = v_s + page_size * HD;
  float* acc_s = p_s + group * page_size;
  float* m_s = acc_s + group * HD;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int length = lengths[s];
  const size_t head_off = ((size_t)s * n_kv + h) * group * HD;
  for (int i = tid; i < group * HD; i += blockDim.x) {
    q_s[i] = to_f32(q[head_off + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    m_s[g] = kNegBig;
    l_s[g] = 0.f;
  }
  __syncthreads();

  int live = length > 0 ? (length + page_size - 1) / page_size : 0;
  live = live < max_pages ? live : max_pages;
  const int32_t* ptab = page_table + (size_t)s * max_pages;
  const size_t row = (size_t)n_kv * HD;  // stride between a page's rows

  for (int p = 0; p < live; ++p) {
    const size_t page = (size_t)ptab[p];
    const int base = p * page_size;
    const bool boundary = base + page_size > length;
    const T* kp = k_pages + page * page_size * row + (size_t)h * HD;
    const T* vp = v_pages + page * page_size * row + (size_t)h * HD;
    for (int i = tid; i < page_size * HD; i += blockDim.x) {
      const int t = i / HD;
      const int d = i - t * HD;
      k_s[t * KP + d] = to_f32(kp[t * row + d]);
      v_s[i] = to_f32(vp[t * row + d]);
    }
    __syncthreads();

    // scores in the base-2 domain: one (query row, key) pair per thread
    for (int i = tid; i < group * page_size; i += blockDim.x) {
      const int g = i / page_size;
      const int t = i - g * page_size;
      const float* qr = q_s + g * HD;
      const float* kr = k_s + t * KP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      float sc = dot * qk_scale_log2;
      if (boundary && base + t >= length) sc = kNegBig;
      p_s[i] = sc;
    }
    __syncthreads();

    // online-softmax fold, one warp per query row
    for (int g = warp; g < group; g += nwarps) {
      float* r = p_s + g * page_size;
      float mx = kNegBig;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, r[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        // masked entries are re-masked: a row still fully masked would
        // give exp2(0) = 1 there
        const bool masked = boundary && base + t >= length;
        const float pr = masked ? 0.f : exp2f(r[t] - m_new);
        sum += pr;
        // p enters the PV product in the value dtype, as the reference
        // casts it (a no-op for f32)
        r[t] = to_f32(from_f32<T>(pr));
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p . V, one (query row, dim) pair per thread
    for (int i = tid; i < group * HD; i += blockDim.x) {
      const int g = i / HD;
      const int d = i - g * HD;
      const float* pr = p_s + g * page_size;
      float a = 0.f;
      for (int t = 0; t < page_size; ++t) a += pr[t] * v_s[t * HD + d];
      acc_s[i] = alpha_s[g] * acc_s[i] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * HD; i += blockDim.x) {
    const int g = i / HD;
    out[head_off + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* ptab,
           const void* lens, void* out, int slots, int n_kv, int group,
           int page_size, int max_pages, float qk_scale_log2,
           cudaStream_t stream) {
  const size_t smem = smem_floats(group, HD, page_size) * sizeof(float);
  auto kern = ragged_paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(slots, n_kv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(ptab),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), n_kv, group,
      page_size, max_pages, qk_scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t tft_ragged_paged_attention_smem_bytes(int group, int head_dim,
                                             int page_size) {
  return smem_floats(group, head_dim, page_size) * sizeof(float);
}

// dtype_code: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported dtype/head_dim).
int tft_ragged_paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* out, int slots,
                               int n_kv, int group, int head_dim,
                               int page_size, int max_pages, int dtype_code,
                               float qk_scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TFT_RPA(T, HD)                                                     \
  return launch<T, HD>(q, k_pages, v_pages, page_table, lengths, out,      \
                       slots, n_kv, group, page_size, max_pages,           \
                       qk_scale_log2, st)
  if (dtype_code == 0 && head_dim == 64) TFT_RPA(float, 64);
  if (dtype_code == 0 && head_dim == 128) TFT_RPA(float, 128);
  if (dtype_code == 1 && head_dim == 64) TFT_RPA(__nv_bfloat16, 64);
  if (dtype_code == 1 && head_dim == 128) TFT_RPA(__nv_bfloat16, 128);
#undef TFT_RPA
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

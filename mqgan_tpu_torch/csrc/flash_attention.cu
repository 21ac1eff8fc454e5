// Causal flash attention for training: the C entry points, which dispatch
// on the head size, its layout and the dtype to the kernels of
// flash_attention.cuh (its comment says what they compute and how). This
// file instantiates the tiles' D = 32, 64 and 128 of fp32 and of bf16 heads
// that fill their tiles in 16-byte copies; flash_attention_wide.cu,
// flash_attention_any.cu and flash_attention_any_wide.cu the rest, built
// in parallel with it; flash_attention_chunked.cu holds the kernels of the
// multiples of 128 past 256.

#include "flash_attention.cuh"

namespace mqgan_flash {

MQGAN_FLASH_WIDE_SIZES(extern)
MQGAN_FLASH_ANY_SIZES(extern)
MQGAN_FLASH_ANY_WIDE_SIZES(extern)

// the tiles' D of a head of d columns: d rounded up to 32, 64, 96 or 128,
// or 256; 0 past 128 but for 256 (the larger multiples of 128 take the
// chunked kernels before this dispatch; any other d is refused, and the
// wrapper raises first, naming the sizes)
inline int tile_cols(int d) {
  if (d < 1) return 0;
  if (d <= 128) return (d + 31) / 32 * 32;
  return d == 256 ? 256 : 0;
}

// dispatch on the tiles' D, the dtype and, in bf16 up to D = 128, whether
// the head fills its tiles in 16-byte copies (kernels built for that
// layout alone: code for other layouts in the same kernel cost the
// flagship's D = 64 3-16% on an H100) or not (the kernels for any head;
// at D = 256 the only ones: built for that layout alone, the dQ kernel
// spilled); a vec that does not divide d is refused
#define MQGAN_FLASH_CASE(D, FN, ...)                                          \
  case D:                                                                      \
    if (!is_bf16) return FN<float, D, true>(__VA_ARGS__);                      \
    return s.hd.d == D && s.hd.vec == 8 ? FN<__nv_bfloat16, D, false>(__VA_ARGS__) \
                                        : FN<__nv_bfloat16, D, true>(__VA_ARGS__);
#define MQGAN_FLASH_CASE_ANY(D, FN, ...)                                      \
  case D:                                                                      \
    return is_bf16 ? FN<__nv_bfloat16, D, true>(__VA_ARGS__)                   \
                   : FN<float, D, true>(__VA_ARGS__);
#define MQGAN_FLASH_DISPATCH(FN, ...)                                          \
  if (s.hd.vec < 1 || s.hd.vec > 8 || s.hd.d % s.hd.vec) return cudaErrorInvalidValue; \
  switch (tile_cols(s.hd.d)) {                                                 \
    MQGAN_FLASH_CASE(32, FN, __VA_ARGS__)                                      \
    MQGAN_FLASH_CASE(64, FN, __VA_ARGS__)                                      \
    MQGAN_FLASH_CASE(96, FN, __VA_ARGS__)                                      \
    MQGAN_FLASH_CASE(128, FN, __VA_ARGS__)                                     \
    MQGAN_FLASH_CASE_ANY(256, FN, __VA_ARGS__)                                 \
    default:                                                                   \
      return cudaErrorInvalidValue;                                            \
  }

}  // namespace mqgan_flash

using namespace mqgan_flash;  // NOLINT: the dispatch macro names its launchers

// d is the head size, vec the elements a copy moves (a power of two up to 8
// that divides d and every pointer's alignment in elements)
extern "C" int mqgan_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int t, int h, int d,
                               int vec, int is_bf16, float scale, void* stream) {
  const Shape s{b, t, h, Head{d, vec}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (chunked_head(s.hd.d)) return fwd_chunked(q, k, v, o, lse_f, s, scale, is_bf16, st);
  MQGAN_FLASH_DISPATCH(fwd, q, k, v, o, lse_f, s, scale, st)
}

extern "C" int mqgan_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int b, int t, int h, int d, int vec, int is_bf16,
                                  float scale, void* stream) {
  const Shape s{b, t, h, Head{d, vec}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (chunked_head(s.hd.d))
    return bwd_dq_chunked(q, k, v, o, dout, lse_f, delta_f, dq, s, scale, is_bf16, st);
  MQGAN_FLASH_DISPATCH(bwd_dq, q, k, v, o, dout, lse_f, delta_f, dq, s, scale, st)
}

extern "C" int mqgan_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int b, int t, int h, int d, int vec, int is_bf16,
                                   float scale, void* stream) {
  const Shape s{b, t, h, Head{d, vec}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (chunked_head(s.hd.d))
    return bwd_dkv_chunked(q, k, v, dout, lse_f, delta_f, dk, dv, s, scale, is_bf16, st);
  MQGAN_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse_f, delta_f, dk, dv, s, scale, st)
}

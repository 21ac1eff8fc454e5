// Log-mel front end by DFT product: reflect-padded waveform -> (frames,
// n_mels) log-mel, in fp32. The route of ops/stft_kernels.py for an n_fft
// that no FFT kernel (log_mel.cu, log_mel_mixed.cu, log_mel_bluestein.cu)
// takes: n_fft 1 and 2, odd n_fft past 9603 and even n_fft past 14406 (past
// the Bluestein kernel's 14406-point chirp-z length), framed as the JAX
// package frames them ((samples - 1) // hop + 1 frames at an odd n_fft
// where hop divides the samples). Until the Bluestein kernel it took every
// odd n_fft and every n_fft / 2 with a prime factor above 7 (2050 = 2 *
// 5^2 * 41, say).
//
// Replaces: mqgan_tpu/ops/stft_kernels.py:_log_mel_frames_pallas (the
// Pallas TPU kernel `_kernel` behind PallasMelFrontend), which is this same
// DFT product, for those shapes.
//
//   re[n, f]  = sum_j x[n, j] * cos[j, f]       (window folded into cos/sin)
//   im[n, f]  = sum_j x[n, j] * sin[j, f]
//   out[n, m] = log(max(sum_f sqrt(re^2 + im^2) * fbank[f, m], 1e-5))
//
// Frame n = (b, t) is read in place: sample j is wav_pad[b * stride +
// t * hop + j]. The (N, n_fft) frame matrix never exists in device memory.
//
// What bounds it: operations. The DFT as a product is 4 * N * n_fft * F
// flops, against about 2.5 * n_fft * log2(n_fft) per frame for an FFT: at
// n_fft 2048 that is 275 GFLOP for 32768 frames against the function's
// 2.1 GFLOP (FFT, magnitudes, the filterbank's nonzeros, log), about 130
// times the work. It stays for the shapes the power-of-two FFT does not
// take.
//
// Why fp32 on CUDA cores, without TF32 or bf16 tensor cores: TF32 keeps
// about three decimal digits, which in the log domain is an error of ~1e-3,
// over the 5e-4 the front end is held to against the JAX reference.
//
// Design: a block owns 64 frames and walks the frequency axis in tiles of
// 64 bins. For each tile it accumulates re and im over n_fft through
// shared-memory stages of 16 samples (frames stored transposed, cos and
// sin row-major; the next stage is prefetched into registers while the
// current one is consumed; samples past n_fft in the last stage read as
// zeros); each thread holds an 8-frame x 4-bin tile of both re and im, so
// the magnitude is formed in registers. The magnitudes go to shared memory
// and are projected onto the filterbank, each thread owning whole mel
// columns of the block's 64 output rows: it adds each tile's sums to the
// rows in device memory (in registers, 64 at a time), and after the last
// tile writes the clamp and the log there. No atomics, so the result is
// deterministic, and shared memory does not grow with n_mels (any n_mels;
// a (64, n_mels) accumulator in shared memory passed an H100 block's 227
// KB past 795 mels). F = n_fft/2+1 is not padded: loads past F read zeros.
// Exact sqrtf and logf: the library is built without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 64;    // frames per block
constexpr int kTileF = 64;    // frequency bins per tile
constexpr int kTileK = 16;    // samples per shared-memory stage
constexpr int kThreads = 128;
constexpr int kRows = 8;      // frames per thread
constexpr int kCols = 4;      // bins per thread (re and im each)
constexpr int kAStride = kTileN + 4;  // transposed frame tile, padded rows
constexpr float kLogClip = 1e-5f;

static_assert(kThreads == (kTileN / kRows) * (kTileF / kCols), "thread tile");
static_assert(kTileN * kTileK == kThreads * kRows, "frame stage loads");
static_assert(kTileF * kTileK == kThreads * 8, "table stage loads");

__global__ void __launch_bounds__(kThreads)
log_mel_dft_kernel(const float* __restrict__ wav, const float* __restrict__ cosw,
               const float* __restrict__ sinw,
               const float* __restrict__ fbank, float* __restrict__ out,
               int n_total, int frames_per_clip, int row_stride, int hop,
               int n_fft, int n_freq, int n_mels) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [kTileK][kAStride]
  float* c_s = a_s + kTileK * kAStride;          // [kTileK][kTileF]
  float* s_s = c_s + kTileK * kTileF;            // [kTileK][kTileF]
  float* mag_s = s_s + kTileK * kTileF;          // [kTileN][kTileF]

  const int tid = threadIdx.x;
  const int tx = tid % (kTileF / kCols);  // bins tx*4 .. tx*4+3
  const int ty = tid / (kTileF / kCols);  // frames ty*8 .. ty*8+7
  const int n0 = blockIdx.x * kTileN;

  // Stage loads. Frames: this thread loads sample (k0 + a_kk) of frames
  // a_row + 8r; consecutive threads read consecutive samples of one frame.
  const int a_kk = tid % kTileK;
  const int a_row = tid / kTileK;
  int a_base[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + a_row + 8 * r;
    if (n < n_total) {
      const int b = n / frames_per_clip;
      const int t = n - b * frames_per_clip;
      a_base[r] = b * row_stride + t * hop + a_kk;
    } else {
      a_base[r] = -1;
    }
  }
  // Tables: bin b_f of rows b_kk + 2r; consecutive threads, consecutive bins.
  const int b_f = tid % kTileF;
  const int b_kk = tid / kTileF;

  float a_reg[kRows], c_reg[8], s_reg[8];
  auto load_stage = [&](int f0, int k0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a_reg[r] = a_base[r] >= 0 && k0 + a_kk < n_fft ? wav[a_base[r] + k0] : 0.0f;
    }
    const int f = f0 + b_f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = k0 + b_kk + 2 * r;
      const size_t idx = static_cast<size_t>(row) * n_freq + f;
      c_reg[r] = f < n_freq && row < n_fft ? cosw[idx] : 0.0f;
      s_reg[r] = f < n_freq && row < n_fft ? sinw[idx] : 0.0f;
    }
  };
  auto store_stage = [&]() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a_s[a_kk * kAStride + a_row + 8 * r] = a_reg[r];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      c_s[(b_kk + 2 * r) * kTileF + b_f] = c_reg[r];
      s_s[(b_kk + 2 * r) * kTileF + b_f] = s_reg[r];
    }
  };

  const int n_ftiles = (n_freq + kTileF - 1) / kTileF;
  const int n_ksteps = (n_fft + kTileK - 1) / kTileK;
  load_stage(0, 0);
  for (int ft = 0; ft < n_ftiles; ++ft) {
    const int f0 = ft * kTileF;
    float re[kRows][kCols], im[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) re[r][c] = im[r][c] = 0.0f;
    }

    for (int ks = 0; ks < n_ksteps; ++ks) {
      __syncthreads();  // every reader of the previous stage is done
      store_stage();
      __syncthreads();
      if (ks + 1 < n_ksteps) {
        load_stage(f0, (ks + 1) * kTileK);
      } else if (ft + 1 < n_ftiles) {
        load_stage(f0 + kTileF, 0);
      }
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            &a_s[kk * kAStride + ty * kRows]);
        const float4 a1 = *reinterpret_cast<const float4*>(
            &a_s[kk * kAStride + ty * kRows + 4]);
        const float4 cv = *reinterpret_cast<const float4*>(
            &c_s[kk * kTileF + tx * kCols]);
        const float4 sv = *reinterpret_cast<const float4*>(
            &s_s[kk * kTileF + tx * kCols]);
        const float av[kRows] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
        const float cc[kCols] = {cv.x, cv.y, cv.z, cv.w};
        const float ss[kCols] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            re[r][c] = fmaf(av[r], cc[c], re[r][c]);
            im[r][c] = fmaf(av[r], ss[c], im[r][c]);
          }
        }
      }
    }

    // magnitudes of this tile (zero past n_freq: those table columns are 0)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float4 m;
      m.x = sqrtf(re[r][0] * re[r][0] + im[r][0] * im[r][0]);
      m.y = sqrtf(re[r][1] * re[r][1] + im[r][1] * im[r][1]);
      m.z = sqrtf(re[r][2] * re[r][2] + im[r][2] * im[r][2]);
      m.w = sqrtf(re[r][3] * re[r][3] + im[r][3] * im[r][3]);
      *reinterpret_cast<float4*>(&mag_s[(ty * kRows + r) * kTileF + tx * kCols]) = m;
    }
    __syncthreads();

    // out[n][m] += sum_f mag[n][f] * fbank[f0 + f][m]: each thread owns
    // whole columns m of the block's rows, summed in device memory across
    // the tiles (the first starts from 0, the last writes the log)
    const int f_len = min(kTileF, n_freq - f0);
    const int n_rows = min(kTileN, n_total - n0);
    const bool last = ft + 1 == n_ftiles;
    for (int m = tid; m < n_mels; m += kThreads) {
      float* col = out + static_cast<size_t>(n0) * n_mels + m;
      float acc[kTileN];
#pragma unroll
      for (int n = 0; n < kTileN; ++n)
        acc[n] = ft > 0 && n < n_rows ? col[static_cast<size_t>(n) * n_mels] : 0.0f;
      for (int f = 0; f < f_len; f += 4) {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = f + j < f_len
                     ? fbank[static_cast<size_t>(f0 + f + j) * n_mels + m]
                     : 0.0f;
        }
#pragma unroll
        for (int n = 0; n < kTileN; ++n) {
          const float4 mv =
              *reinterpret_cast<const float4*>(&mag_s[n * kTileF + f]);
          acc[n] = fmaf(mv.x, w[0], acc[n]);
          acc[n] = fmaf(mv.y, w[1], acc[n]);
          acc[n] = fmaf(mv.z, w[2], acc[n]);
          acc[n] = fmaf(mv.w, w[3], acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kTileN; ++n) {
        if (n < n_rows)
          col[static_cast<size_t>(n) * n_mels] = last ? logf(fmaxf(acc[n], kLogClip)) : acc[n];
      }
    }
  }
}

}  // namespace

extern "C" int mqgan_log_mel_dft(const void* wav_pad, const void* cosw,
                                 const void* sinw, const void* fbank,
                                 void* out, int n_clips, int frames_per_clip,
                                 int row_stride, int hop, int n_fft,
                                 int n_freq, int n_mels, void* stream) {
  const int n_total = n_clips * frames_per_clip;
  const size_t smem =
      sizeof(float) * (kTileK * kAStride + 2 * kTileK * kTileF + kTileN * kTileF);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_total + kTileN - 1) / kTileN);
  log_mel_dft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav_pad), static_cast<const float*>(cosw),
      static_cast<const float*>(sinw), static_cast<const float*>(fbank),
      static_cast<float*>(out), n_total, frames_per_clip, row_stride, hop,
      n_fft, n_freq, n_mels);
  return static_cast<int>(cudaGetLastError());
}

// Native host-side feature-extraction runtime for the TTS data pipeline
// (the port's own copy of msa_tts_tpu/native/feats.cpp: the same source,
// so both packages compute the same features bit for bit).
//
// Reimplements, in C++ with a thread pool, the DSP that the dataset cache
// construction otherwise runs sequentially in numpy (ops/audio.py):
//
//   * margin-silence trim        (ops/audio.py trim_margin_silence_slice;
//                                 reference msa_tts/utils/ap.py:95-112)
//   * "ap"  log10 power-mel      (ops/audio.py melspec_ap;
//                                 reference msa_tts/utils/ap.py:63-80)
//   * "ap2" HiFi-GAN ln mag-mel  (ops/audio.py melspec_ap2;
//                                 reference msa_tts/utils/ap2.py:32-59)
//   * polyphase resampling       (scipy.signal.resample_poly's default
//                                 filter and alignment)
//
// Numeric parity notes (tests/test_torch_native.py asserts these):
//   - numpy's rfft promotes float32 input to float64, so all spectral math
//     here runs in double; windows and the mel filterbank stay float32 and
//     the windowed frame is formed in float32 before promotion, matching
//     the numpy pipeline's dtype chain exactly.
//   - the FFT is an iterative radix-2 Cooley-Tukey in double; n_fft must
//     be a power of two (1024/2048 in every shipped config).
//
// No device sees this code: it is host runtime feeding the training and
// serving input pipelines.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// ------------------------------------------------------------------ FFT

// Shared, read-only plan for a real FFT of size n, computed as a
// complex FFT of size n/2 over packed even/odd samples plus an O(n)
// untangling pass (the standard real-input trick — halves the FFT work
// vs a full complex transform with zero imaginary part).
struct FftPlan {
  int n = 0;        // real transform size (power of two)
  int half = 0;     // complex FFT size = n / 2
  std::vector<int> bitrev;           // for the half-size complex FFT
  std::vector<double> tw_re, tw_im;  // stage-packed twiddles (half-size)
  std::vector<double> un_re, un_im;  // untangle twiddles e^{-2πik/n}

  explicit FftPlan(int n_) : n(n_), half(n_ / 2) {
    bitrev.resize(half);
    int lg = 0;
    while ((1 << lg) < half) ++lg;
    for (int i = 0; i < half; ++i) {
      int r = 0;
      for (int b = 0; b < lg; ++b) r |= ((i >> b) & 1) << (lg - 1 - b);
      bitrev[i] = r;
    }
    for (int len = 2; len <= half; len <<= 1) {
      for (int k = 0; k < len / 2; ++k) {
        double ang = -2.0 * kPi * k / len;
        tw_re.push_back(std::cos(ang));
        tw_im.push_back(std::sin(ang));
      }
    }
    un_re.resize(half + 1);
    un_im.resize(half + 1);
    for (int k = 0; k <= half; ++k) {
      double ang = -2.0 * kPi * k / n;
      un_re[k] = std::cos(ang);
      un_im[k] = std::sin(ang);
    }
  }
};

// In-place complex FFT of size plan.half over (re, im).
void fft_inplace(const FftPlan& plan, double* re, double* im) {
  const int n = plan.half;
  for (int i = 0; i < n; ++i) {
    int j = plan.bitrev[i];
    if (j > i) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  size_t tw_off = 0;
  for (int len = 2; len <= n; len <<= 1) {
    const int half = len / 2;
    const double* wre = plan.tw_re.data() + tw_off;
    const double* wim = plan.tw_im.data() + tw_off;
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < half; ++k) {
        const int a = i + k, b = i + k + half;
        const double ur = re[a], ui = im[a];
        const double vr = re[b] * wre[k] - im[b] * wim[k];
        const double vi = re[b] * wim[k] + im[b] * wre[k];
        re[a] = ur + vr;
        im[a] = ui + vi;
        re[b] = ur - vr;
        im[b] = ui - vi;
      }
    }
    tw_off += half;
  }
}

// Real FFT of frame[0..n): pack even/odd into a half-size complex FFT,
// then untangle into the n/2 + 1 non-redundant bins.
//   X[k] = E[k] + e^{-2πik/n} O[k],  where for Z = FFT(x_even + i·x_odd):
//   E[k] = (Z[k] + conj(Z[h-k])) / 2,  O[k] = -i (Z[k] - conj(Z[h-k])) / 2
// re/im are scratch of size half; out_re/out_im have n/2 + 1 slots.
void rfft(const FftPlan& plan, const float* frame, double* re, double* im,
          double* out_re, double* out_im) {
  const int h = plan.half;
  for (int k = 0; k < h; ++k) {
    re[k] = static_cast<double>(frame[2 * k]);
    im[k] = static_cast<double>(frame[2 * k + 1]);
  }
  fft_inplace(plan, re, im);
  for (int k = 0; k <= h; ++k) {
    const int k1 = k == h ? 0 : k;          // Z[h] wraps to Z[0]
    const int k2 = (h - k) == h ? 0 : h - k;
    const double zr1 = re[k1], zi1 = im[k1];
    const double zr2 = re[k2], zi2 = -im[k2];  // conj(Z[h-k])
    const double er = 0.5 * (zr1 + zr2);
    const double ei = 0.5 * (zi1 + zi2);
    // O[k] = -i (Z[k] - conj(Z[h-k])) / 2 = (imag_diff, -real_diff) / 2
    const double or_ = 0.5 * (zi1 - zi2);
    const double oi = -0.5 * (zr1 - zr2);
    const double wr = plan.un_re[k], wi = plan.un_im[k];
    out_re[k] = er + wr * or_ - wi * oi;
    out_im[k] = ei + wr * oi + wi * or_;
  }
}

// ------------------------------------------------------------- helpers

// Periodic Hann window of win_length, computed in float32 (matches
// ops/audio.py hann_window(xp=np, float32)), zero-padded centered to n_fft.
std::vector<float> make_window(int n_fft, int win_length) {
  std::vector<float> w(n_fft, 0.0f);
  const int lpad = (n_fft - win_length) / 2;
  for (int i = 0; i < win_length; ++i) {
    w[lpad + i] = static_cast<float>(
        0.5 * (1.0 - std::cos(2.0 * kPi * static_cast<float>(i) /
                              static_cast<float>(win_length))));
  }
  return w;
}

// numpy-style "reflect" (no edge repeat) padding of src into dst.
// dst must have room for n + lpad + rpad floats.  Requires n > 1.
void reflect_pad(const float* src, int64_t n, int lpad, int rpad,
                 float* dst) {
  const int64_t period = 2 * (n - 1);
  for (int64_t i = -lpad; i < n + rpad; ++i) {
    int64_t j = i;
    // Mirror into [0, n): indices follow a triangle wave of period 2(n-1).
    j = ((j % period) + period) % period;
    if (j >= n) j = period - j;
    dst[i + lpad] = src[j];
  }
}

struct Job {
  const float* wav;
  int64_t n;
  float* out_mel;       // (n_mels, n_frames_max) row-major
  int64_t* out_frames;  // actual frame count written
  int64_t* trim_start;  // post-trim slice into the original wav
  int64_t* trim_end;
};

struct Config {
  int trim_enable;
  float ref_level_db;
  int trim_frame;
  int trim_hop;
  int flavor;  // 0 = ap (log10 power mel), 1 = ap2 (ln magnitude mel)
  int n_fft;
  int win_length;
  int hop_length;
  int center;         // ap: always 1; ap2: usually 0
  const float* fb;    // (n_freqs, n_mels) row-major float32
  int n_mels;
};

// librosa.effects.trim semantics (ops/audio.py trim_margin_silence).
void trim_silence(const float* wav, int64_t n, float ref_level_db,
                  int frame_length, int hop_length, int64_t* start,
                  int64_t* end) {
  *start = 0;
  *end = n;
  if (n == 0) return;
  const int pad = frame_length / 2;
  const int64_t padded = n + 2 * pad;
  if (padded < frame_length) return;
  const int64_t n_frames = 1 + (padded - frame_length) / hop_length;
  std::vector<double> power(n_frames);
  double ref = 0.0;
  for (int64_t f = 0; f < n_frames; ++f) {
    const int64_t base = f * hop_length - pad;  // index into wav
    double acc = 0.0;
    for (int i = 0; i < frame_length; ++i) {
      const int64_t j = base + i;
      if (j >= 0 && j < n) {
        const double v = wav[j];
        acc += v * v;
      }
    }
    power[f] = acc / frame_length;
    if (power[f] > ref) ref = power[f];
  }
  if (ref <= 0.0) return;  // all-zero signal: keep as is
  int64_t first = -1, last = -1;
  for (int64_t f = 0; f < n_frames; ++f) {
    const double p = power[f] < 1e-20 ? 1e-20 : power[f];
    const double db = 10.0 * std::log10(p / ref);
    if (db > -static_cast<double>(ref_level_db)) {
      if (first < 0) first = f;
      last = f;
    }
  }
  if (first < 0) {  // fully silent: empty slice
    *start = 0;
    *end = 0;
    return;
  }
  *start = first * hop_length;
  const int64_t e = (last + 1) * hop_length;
  *end = e < n ? e : n;
}

// One utterance: optional trim, pad, frame, window, FFT, mel, log.
void process_one(const Config& cfg, const FftPlan& plan, const Job& job,
                 std::vector<float>& padbuf, std::vector<double>& re,
                 std::vector<double>& im) {
  const float* wav = job.wav;
  int64_t n = job.n;

  int64_t t0 = 0, t1 = n;
  if (cfg.trim_enable) {
    trim_silence(wav, n, cfg.ref_level_db, cfg.trim_frame, cfg.trim_hop,
                 &t0, &t1);
  }
  *job.trim_start = t0;
  *job.trim_end = t1;
  wav += t0;
  n = t1 - t0;

  const int n_fft = cfg.n_fft;
  const int hop = cfg.hop_length;
  const int n_freqs = n_fft / 2 + 1;
  const int n_mels = cfg.n_mels;

  // Padding: ap2 pre-pads (n_fft - hop) / 2; stft center adds n_fft / 2.
  // Two sequential reflect pads are NOT one reflect pad of the sum, so
  // apply them in order exactly as the numpy pipeline does.
  int pad1 = (cfg.flavor == 1) ? (n_fft - hop) / 2 : 0;
  int pad2 = cfg.center ? n_fft / 2 : 0;

  // reflect_pad's triangle-wave indexing handles pads larger than the
  // signal (numpy repeats the reflection), so the only hard minimum is
  // two samples for a non-degenerate mirror period.
  if (n < 2) {
    *job.out_frames = 0;
    return;
  }
  padbuf.resize(n + 2 * (pad1 + pad2));
  if (pad1 > 0) {
    std::vector<float> tmp(n + 2 * pad1);
    reflect_pad(wav, n, pad1, pad1, tmp.data());
    if (pad2 > 0) {
      reflect_pad(tmp.data(), tmp.size(), pad2, pad2, padbuf.data());
    } else {
      std::memcpy(padbuf.data(), tmp.data(), tmp.size() * sizeof(float));
    }
  } else if (pad2 > 0) {
    reflect_pad(wav, n, pad2, pad2, padbuf.data());
  } else {
    std::memcpy(padbuf.data(), wav, n * sizeof(float));
  }

  const int64_t padded_len = padbuf.size();
  if (padded_len < n_fft) {
    *job.out_frames = 0;
    return;
  }
  const int64_t n_frames = 1 + (padded_len - n_fft) / hop;
  *job.out_frames = n_frames;

  const std::vector<float> window = make_window(n_fft, cfg.win_length);
  std::vector<float> wframe(n_fft);
  std::vector<double> spec(n_freqs);
  std::vector<double> out_re(n_freqs), out_im(n_freqs);

  // Each triangular mel filter is nonzero on one contiguous frequency
  // band; restricting the projection to [band_lo, band_hi) cuts the
  // mel matmul from n_freqs·n_mels to ~2·n_freqs multiplies per frame.
  std::vector<int> band_lo(n_mels, n_freqs), band_hi(n_mels, 0);
  for (int k = 0; k < n_freqs; ++k) {
    for (int m = 0; m < n_mels; ++m) {
      if (cfg.fb[static_cast<size_t>(k) * n_mels + m] != 0.0f) {
        if (k < band_lo[m]) band_lo[m] = k;
        if (k + 1 > band_hi[m]) band_hi[m] = k + 1;
      }
    }
  }

  for (int64_t f = 0; f < n_frames; ++f) {
    const float* frame = padbuf.data() + f * hop;
    // float32 multiply first (numpy frames*window in float32), then
    // promote to double inside rfft (numpy rfft promotion).
    for (int i = 0; i < n_fft; ++i) wframe[i] = frame[i] * window[i];
    rfft(plan, wframe.data(), re.data(), im.data(), out_re.data(),
         out_im.data());
    if (cfg.flavor == 0) {  // power spectrogram
      for (int k = 0; k < n_freqs; ++k)
        spec[k] = out_re[k] * out_re[k] + out_im[k] * out_im[k];
    } else {  // magnitude with HiFi-GAN epsilon inside the sqrt
      for (int k = 0; k < n_freqs; ++k)
        spec[k] = std::sqrt(out_re[k] * out_re[k] + out_im[k] * out_im[k] +
                            1e-9);
    }
    // mel = fb^T spec over each filter's band; fb float32 promoted
    // per-element (numpy matmul float64 @ float32 -> float64).
    for (int m = 0; m < n_mels; ++m) {
      double acc = 0.0;
      for (int k = band_lo[m]; k < band_hi[m]; ++k) {
        acc += spec[k] *
               static_cast<double>(cfg.fb[static_cast<size_t>(k) * n_mels + m]);
      }
      double v;
      if (cfg.flavor == 0) {
        v = std::log10(acc < 1e-10 ? 1e-10 : acc);
      } else {
        v = std::log(acc < 1e-5 ? 1e-5 : acc);
      }
      // Packed (n_mels, n_frames) row-major with the ACTUAL frame count
      // as the row stride; the caller reshapes via out_frames.
      job.out_mel[static_cast<size_t>(m) * static_cast<size_t>(n_frames) +
                  static_cast<size_t>(f)] = static_cast<float>(v);
    }
  }
}

// ------------------------------------------------------------ resampler
// Rational polyphase resampling (up/down after gcd reduction) with the
// same filter design scipy.signal.resample_poly uses by default — a
// kaiser(beta=5.0)-windowed sinc lowpass, 10*max(up,down) taps per
// side, cutoff 1/max(up,down) of Nyquist, unity DC gain, scaled by
// ``up`` — and the same output alignment, so the numpy fallback in
// ops/audio.py load_wav and this engine agree to float32 rounding
// (tests/test_torch_native.py).  Accumulation is double throughout,
// matching numpy's float32×float64 promotion.

double bessel_i0(double x) {
  // modified Bessel I0 by its power series; converges quickly for the
  // |x| <= beta range a kaiser window evaluates
  double sum = 1.0, term = 1.0;
  const double q = x * x / 4.0;
  for (int k = 1; k < 500; ++k) {
    term *= q / (static_cast<double>(k) * static_cast<double>(k));
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

std::vector<double> design_resample_filter(int up, int down) {
  const int max_rate = up > down ? up : down;
  const double f_c = 1.0 / max_rate;        // Nyquist-normalized cutoff
  const int half_len = 10 * max_rate;
  const int n_taps = 2 * half_len + 1;
  std::vector<double> h(n_taps);
  const double alpha = 0.5 * (n_taps - 1);
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  double dc = 0.0;
  for (int i = 0; i < n_taps; ++i) {
    const double m = i - alpha;
    const double s =
        (m == 0.0) ? f_c : std::sin(kPi * f_c * m) / (kPi * m);
    const double r = 2.0 * i / static_cast<double>(n_taps - 1) - 1.0;
    const double w =
        bessel_i0(beta * std::sqrt(1.0 - r * r > 0 ? 1.0 - r * r : 0.0)) /
        i0b;
    h[i] = s * w;
    dc += h[i];
  }
  const double g = static_cast<double>(up) / dc;  // unity DC gain × up
  for (auto& v : h) v *= g;
  return h;
}

int64_t resample_out_len(int64_t n_in, int up, int down) {
  const int64_t prod = n_in * static_cast<int64_t>(up);
  return prod / down + (prod % down != 0 ? 1 : 0);
}

// Polyphase branch table: hp[p][j] = h[p + j*up], zero-padded to a
// common branch length — per-output tap access becomes contiguous
// instead of striding by ``up`` through the prototype filter.
struct PolyphaseFilter {
  int up = 0;
  int n_taps = 0;                // prototype length (before padding)
  int branch_len = 0;            // ceil(n_taps / up)
  std::vector<double> hp;        // up × branch_len, row-major

  PolyphaseFilter(const std::vector<double>& h, int up_)
      : up(up_), n_taps(static_cast<int>(h.size())) {
    branch_len = (n_taps + up - 1) / up;
    hp.assign(static_cast<size_t>(up) * branch_len, 0.0);
    for (int t = 0; t < n_taps; ++t) {
      hp[static_cast<size_t>(t % up) * branch_len + t / up] = h[t];
    }
  }
};

void resample_one(const float* x, int64_t n_in, int up, int down,
                  const PolyphaseFilter& pf, float* out) {
  if (up == down) {
    std::memcpy(out, x, sizeof(float) * n_in);
    return;
  }
  // scipy's alignment: h is front-padded with (down - half_len % down)
  // zeros and the first (half_len + pad) / down outputs are dropped;
  // folding both into the tap-time offset avoids materializing pads.
  const int hl = (pf.n_taps - 1) / 2;
  const int n_pre_pad = down - (hl % down);
  const int64_t n_pre_remove = (hl + n_pre_pad) / down;
  const int64_t n_out = resample_out_len(n_in, up, down);
  const int L = pf.branch_len;
  for (int64_t k = 0; k < n_out; ++k) {
    const int64_t s =
        (k + n_pre_remove) * static_cast<int64_t>(down) - n_pre_pad;
    // tap t = s - n*up ∈ [0, n_taps): phase p = s % up is constant per
    // output; branch index j walks x backwards from q = (s - p) / up
    const int p = static_cast<int>(s % up);
    const int64_t q = s / up;
    int64_t j_lo = q - (n_in - 1);
    if (j_lo < 0) j_lo = 0;
    int64_t j_hi = q < L - 1 ? q : L - 1;
    const double* hb = &pf.hp[static_cast<size_t>(p) * L];
    double acc = 0.0;
    for (int64_t j = j_lo; j <= j_hi; ++j) {
      acc += hb[j] * static_cast<double>(x[q - j]);
    }
    out[k] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" {

// Output length of msa_resample_batch for one signal (ceil(n*up/down)).
int64_t msa_resample_len(int64_t n_in, int up, int down) {
  return resample_out_len(n_in, up, down);
}

// Threaded batch polyphase resampling.  up/down must be the reduced
// rational rate (gcd == 1); outs[i] must hold msa_resample_len(lens[i])
// float32 samples.  Returns 0 on success.
int msa_resample_batch(const float** wavs, const int64_t* lens, int n,
                       int up, int down, float** outs, int n_threads) {
  if (up <= 0 || down <= 0 || n < 0) return 1;
  const PolyphaseFilter pf(
      (up == down) ? std::vector<double>{0.0}
                   : design_resample_filter(up, down),
      up);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      resample_one(wavs[i], lens[i], up, down, pf, outs[i]);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Batched threaded extraction.  Per utterance i:
//   wavs[i]           float32 waveform of wav_lens[i] samples
//   out_mels[i]       preallocated (n_mels * max_frames_i) float32 where
//                     max_frames_i is the frame count of the UNTRIMMED
//                     signal (an upper bound; trimming only shortens)
//   out_frames[i]     actual frames written (row stride of out_mels[i])
//   trim_start/end[i] slice of the original waveform that was featurized
// Returns 0 on success, nonzero on invalid config.
int msa_extract_batch(const float** wavs, const int64_t* wav_lens,
                      int n_utts, int trim_enable, float ref_level_db,
                      int trim_frame, int trim_hop, int flavor, int n_fft,
                      int win_length, int hop_length, int center,
                      const float* fb, int n_mels, float** out_mels,
                      int64_t* out_frames, int64_t* trim_start,
                      int64_t* trim_end, int n_threads) {
  if (!is_pow2(n_fft) || win_length > n_fft || hop_length <= 0 ||
      n_mels <= 0 || (flavor != 0 && flavor != 1)) {
    return 1;
  }
  const FftPlan plan(n_fft);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_utts) n_threads = n_utts > 0 ? n_utts : 1;

  Config cfg{trim_enable, ref_level_db, trim_frame, trim_hop,
             flavor,      n_fft,        win_length, hop_length,
             center,      fb,           n_mels};

  std::atomic<int> next{0};
  auto worker = [&]() {
    std::vector<float> padbuf;
    std::vector<double> re(n_fft), im(n_fft);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_utts) break;
      Job job{wavs[i],        wav_lens[i],    out_mels[i],
              &out_frames[i], &trim_start[i], &trim_end[i]};
      process_one(cfg, plan, job, padbuf, re, im);
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Standalone trim (librosa.effects.trim semantics) for callers that only
// need the slice bounds.
void msa_trim(const float* wav, int64_t n, float ref_level_db,
              int frame_length, int hop_length, int64_t* start,
              int64_t* end) {
  trim_silence(wav, n, ref_level_db, frame_length, hop_length, start, end);
}

}  // extern "C"

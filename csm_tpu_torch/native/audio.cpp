// csm_tpu_torch native audio runtime: WAV codec + polyphase resampler.
//
// A copy of the JAX package's runtime (same code, so the same compiler gives
// bitwise the same output), playing the role torchaudio's C++ backend plays
// in the reference pipeline (train.py:117-126: load, mono mix, resample).
// Host-side, zero dependencies beyond the C++ standard library; exposed to
// Python through ctypes (csm_tpu_torch/native/__init__.py) with a
// pure-Python fallback when the shared object is unavailable.
//
// Exports (C ABI):
//   wav_read / wav_free        RIFF-WAV decode: PCM 8/16/24/32-bit + float32
//   wav_write                  16-bit PCM encode
//   mono_mix                   channel mean
//   resample_poly_len          output length for a rational resample
//   resample_poly              Kaiser-windowed-sinc polyphase resampling
//                              (scipy.signal.resample_poly-compatible design:
//                              cutoff 1/max(up,down), half-length 10*max,
//                              Kaiser beta 5.0, DC-normalized, up-scaled)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV container
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Returns 0 on success. *out is malloc'd interleaved float32 [-1, 1];
// caller releases with wav_free.
int wav_read(const char* path, float** out, int* channels, int* sample_rate,
             long* frames) {
  *out = nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  {
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    buf.resize(n);
    if (n > 0 && fread(buf.data(), 1, n, f) != (size_t)n) {
      fclose(f);
      return -2;
    }
    fclose(f);
  }
  if (buf.size() < 12 || memcmp(buf.data(), "RIFF", 4) ||
      memcmp(buf.data() + 8, "WAVE", 4))
    return -3;

  uint16_t fmt = 0, n_ch = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > buf.size()) chunk_len = buf.size() - pos - 8;
    if (!memcmp(hdr, "fmt ", 4) && chunk_len >= 16) {
      fmt = rd_u16(body);
      n_ch = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (!memcmp(hdr, "data", 4)) {
      data = body;
      data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are 2-byte aligned
  }
  if (!data || n_ch == 0 || rate == 0) return -4;
  if (fmt != 1 && fmt != 3 && fmt != 0xFFFE) return -5;  // PCM / float / extensible

  int bytes = bits / 8;
  if (bytes < 1 || bytes > 4) return -6;
  long n_frames = (long)(data_len / (bytes * n_ch));
  float* pcm = new float[(size_t)n_frames * n_ch];

  for (long i = 0; i < n_frames * n_ch; i++) {
    const uint8_t* s = data + (size_t)i * bytes;
    float v = 0.f;
    if (fmt == 3 && bits == 32) {
      float fv;
      memcpy(&fv, s, 4);
      v = fv;
    } else if (bits == 8) {
      v = ((int)s[0] - 128) / 128.0f;
    } else if (bits == 16) {
      int16_t x = (int16_t)(s[0] | (s[1] << 8));
      v = x / 32768.0f;
    } else if (bits == 24) {
      int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
      if (x >= (1 << 23)) x -= (1 << 24);
      v = x / 8388608.0f;
    } else if (bits == 32) {
      int32_t x;
      memcpy(&x, s, 4);
      v = x / 2147483648.0f;
    }
    pcm[i] = v;
  }
  *out = pcm;
  *channels = n_ch;
  *sample_rate = (int)rate;
  *frames = n_frames;
  return 0;
}

void wav_free(float* p) { delete[] p; }

static void wr_u32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v & 0xFF);
  b.push_back((v >> 8) & 0xFF);
  b.push_back((v >> 16) & 0xFF);
  b.push_back((v >> 24) & 0xFF);
}
static void wr_u16(std::vector<uint8_t>& b, uint16_t v) {
  b.push_back(v & 0xFF);
  b.push_back((v >> 8) & 0xFF);
}

// 16-bit PCM writer; data is interleaved float32.
int wav_write(const char* path, const float* data, int channels,
              int sample_rate, long frames) {
  std::vector<uint8_t> b;
  uint32_t data_len = (uint32_t)(frames * channels * 2);
  b.reserve(44 + data_len);
  b.insert(b.end(), {'R', 'I', 'F', 'F'});
  wr_u32(b, 36 + data_len);
  b.insert(b.end(), {'W', 'A', 'V', 'E', 'f', 'm', 't', ' '});
  wr_u32(b, 16);
  wr_u16(b, 1);  // PCM
  wr_u16(b, (uint16_t)channels);
  wr_u32(b, (uint32_t)sample_rate);
  wr_u32(b, (uint32_t)(sample_rate * channels * 2));
  wr_u16(b, (uint16_t)(channels * 2));
  wr_u16(b, 16);
  b.insert(b.end(), {'d', 'a', 't', 'a'});
  wr_u32(b, data_len);
  for (long i = 0; i < frames * channels; i++) {
    float v = data[i] * 32767.0f;
    if (v > 32767.f) v = 32767.f;
    if (v < -32768.f) v = -32768.f;
    int16_t x = (int16_t)lrintf(v);
    wr_u16(b, (uint16_t)x);
  }
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(b.data(), 1, b.size(), f);
  fclose(f);
  return n == b.size() ? 0 : -2;
}

void mono_mix(const float* in, int channels, long frames, float* out) {
  for (long t = 0; t < frames; t++) {
    float acc = 0.f;
    for (int c = 0; c < channels; c++) acc += in[(size_t)t * channels + c];
    out[t] = acc / channels;
  }
}

// ---------------------------------------------------------------------------
// Polyphase resampler (scipy.signal.resample_poly-compatible filter design)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // Series expansion; converges fast for the beta range used here.
  double sum = 1.0, term = 1.0;
  double half_x = x / 2.0;
  for (int k = 1; k < 64; k++) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// firwin(2*half_len+1, cutoff=1/max_rate, window=('kaiser', 5.0)),
// normalized to unity DC gain, then scaled by `up` — matching scipy's
// resample_poly default filter.
static std::vector<double> design_filter(int up, int down) {
  int max_rate = up > down ? up : down;
  int half_len = 10 * max_rate;
  int n = 2 * half_len + 1;
  double cutoff = 1.0 / max_rate;  // in Nyquist units
  double beta = 5.0;
  std::vector<double> h(n);
  double denom = bessel_i0(beta);
  double sum = 0.0;
  for (int i = 0; i < n; i++) {
    double m = i - half_len;
    // sinc lowpass at `cutoff` (Nyquist units): cutoff * sinc(cutoff * m)
    double x = cutoff * m;
    double s = (m == 0) ? cutoff : cutoff * std::sin(M_PI * x) / (M_PI * x);
    double r = (double)(i - half_len) / half_len;  // [-1, 1]
    double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / denom;
    h[i] = s * w;
    sum += h[i];
  }
  for (int i = 0; i < n; i++) h[i] = h[i] / sum * up;
  return h;
}

long resample_poly_len(long n_in, int up, int down) {
  return (n_in * (long)up + down - 1) / down;  // ceil
}

// upfirdn(h, x, up, down) trimmed like scipy.resample_poly: the filter's
// group delay (half_len) is compensated so output sample j corresponds to
// input time j*down/up.
void resample_poly(const float* in, long n_in, int up, int down, float* out) {
  if (up == down) {
    memcpy(out, in, sizeof(float) * n_in);
    return;
  }
  std::vector<double> h = design_filter(up, down);
  int half_len = ((int)h.size() - 1) / 2;
  long n_out = resample_poly_len(n_in, up, down);

  // y[j] = sum_k h[k] * x_up[j*down + half_len - k], where
  // x_up[i] = x[i/up] when i % up == 0 else 0.
  for (long j = 0; j < n_out; j++) {
    long center = j * (long)down + half_len;
    double acc = 0.0;
    // k must satisfy (center - k) % up == 0 and 0 <= (center-k)/up < n_in
    long k0 = center % up;  // smallest k with (center - k) divisible by up
    for (long k = k0; k < (long)h.size(); k += up) {
      long i = (center - k) / up;
      if (i < 0) break;       // k too large → i negative for growing k? i decreases as k grows
      if (i >= n_in) continue;  // left of signal start (warm-up region)
      acc += h[k] * in[i];
    }
    out[j] = (float)acc;
  }
}

}  // extern "C"

// Host-side signal-chain runtime for the JAX Viterbi framework.
//
// The device owns the decode compute path (ACS + chainback kernels);
// this library keeps the *host* side of the pipeline native: framing,
// convolutional encoding, channel simulation, puncturing and scoring run
// in C++ worker threads so the Python layer never touches per-bit work.
// It is the framework's equivalent of the reference's native harness
// runtime:
//   * convolutional encoders      - convolutional_encoder_lookup.h:15-82,
//                                   convolutional_encoder_shift_register.h:14-63
//   * signal-chain helpers        - helpers/test_helpers.h:11-104
//   * AWGN + quantisation chain   - examples/run_snr_ber.cpp:337-359
//   * puncturing / depuncturing   - helpers/puncture_code_helpers.h:17-144
//   * popcount error counting     - utility/bitcount_table.h:6-52
//   * thread pool                 - utility/thread_pool.h:10-101
//
// C ABI only (consumed from Python via ctypes - no pybind11 in the image).
// Build: see native/Makefile (g++ -O3 -std=c++17 -shared -fPIC).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Thread pool (equivalent of utility/thread_pool.h:10-101).
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(size_t n) {
    if (n == 0) n = 1;
    for (size_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Loop(); });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void Push(std::function<void()> task) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      ++pending_;
      tasks_.push(std::move(task));
    }
    cv_.notify_one();
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(tasks_.front());
        tasks_.pop();
      }
      task();
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  size_t pending_ = 0;
  bool stop_ = false;
};

// One persistent process-wide pool, sized to the hardware and created on
// first parallel call - like the reference harness's long-lived pool
// (run_benchmark.cpp:144), instead of spawning OS threads per call.
ThreadPool& SharedPool() {
  static ThreadPool pool(std::thread::hardware_concurrency()
                             ? std::thread::hardware_concurrency()
                             : 1);
  return pool;
}

// Shard [0, total) over the shared pool in contiguous ranges and block
// until done.  ``n_threads`` caps the number of shards (<=0 = hardware
// concurrency); tasks are serialized behind a mutex so concurrent
// ParallelFor calls from different host threads do not interleave their
// WaitAll conditions.
void ParallelFor(size_t total, int n_threads,
                 const std::function<void(size_t, size_t)>& fn) {
  // A nested call from inside a worker task must not touch the shared
  // pool (for_mu is held across WaitAll by the outer call): run inline.
  static thread_local bool in_worker = false;
  size_t hw = std::thread::hardware_concurrency();
  size_t n = n_threads > 0 ? static_cast<size_t>(n_threads) : (hw ? hw : 1);
  if (in_worker || n <= 1 || total <= 1) {
    fn(0, total);
    return;
  }
  n = std::min(n, total);
  static std::mutex for_mu;
  std::lock_guard<std::mutex> guard(for_mu);
  ThreadPool& pool = SharedPool();
  size_t chunk = (total + n - 1) / n;
  for (size_t i = 0; i < n; ++i) {
    size_t lo = i * chunk;
    size_t hi = std::min(total, lo + chunk);
    if (lo >= hi) break;
    pool.Push([=, &fn] {
      in_worker = true;
      fn(lo, hi);
      in_worker = false;
    });
  }
  pool.WaitAll();
}

inline uint32_t Parity64(uint64_t x) {
  return static_cast<uint32_t>(__builtin_parityll(x));
}

// ---------------------------------------------------------------------------
// Convolutional encoder.
//
// Bit conventions match the framework (and the reference shift-register
// encoder, convolutional_encoder_shift_register.h:50-60): input bits are
// consumed MSB-first within each byte, the register shifts new bits in at
// the LSB, and output bit j of input bit t is parity(G[j] & reg), laid out
// at position t*R + j of the symbol stream.
// ---------------------------------------------------------------------------
struct Encoder {
  int K = 0;
  int R = 0;
  std::vector<uint64_t> G;
  uint64_t reg_mask = 0;
  // Byte LUT (equivalent of convolutional_encoder_lookup.h:61-81), built
  // when 2^(K-1) * 256 entries is small: entry (state, byte) holds the
  // 8*R output bits (bit 0 = first emitted symbol) and the next state.
  bool has_lut = false;
  std::vector<uint64_t> lut_bits;
  std::vector<uint32_t> lut_next;

  // One input bit through the shift register; returns R output bits packed
  // little-endian in a uint32.
  inline uint32_t StepBit(uint64_t& reg, uint32_t bit) const {
    reg = ((reg << 1) | bit) & reg_mask;
    uint32_t out = 0;
    for (int j = 0; j < R; ++j) out |= Parity64(reg & G[j]) << j;
    return out;
  }
};

Encoder* MakeEncoder(int K, int R, const uint64_t* G) {
  auto* e = new Encoder;
  e->K = K;
  e->R = R;
  e->G.assign(G, G + R);
  e->reg_mask = (K >= 64) ? ~0ull : ((1ull << K) - 1);
  // The reference notes the byte LUT is inappropriate for large K
  // (convolutional_encoder_lookup.h:11-14); gate it at K <= 9 (256
  // states x 256 byte values = 64Ki entries), past which the bitwise
  // path below wins on cache footprint.
  size_t S = 1ull << (K - 1);
  if (K <= 9 && R <= 8) {
    size_t entries = S << 8;
    e->lut_bits.resize(entries);
    e->lut_next.resize(entries);
    for (size_t s = 0; s < S; ++s) {
      for (size_t byte = 0; byte < 256; ++byte) {
        uint64_t reg = s;
        uint64_t bits = 0;
        for (int i = 0; i < 8; ++i) {
          uint32_t b = (byte >> (7 - i)) & 1;
          uint32_t out = e->StepBit(reg, b);
          bits |= static_cast<uint64_t>(out) << (i * R);
        }
        size_t idx = (s << 8) | byte;
        e->lut_bits[idx] = bits;
        // Only the newest K-1 register bits influence future outputs
        // (StepBit shifts before masking to K bits), so they are the state.
        e->lut_next[idx] = static_cast<uint32_t>(reg & (S - 1));
      }
    }
    e->has_lut = true;
  }
  return e;
}

// Encode one frame of data bytes into output *bits* (uint8 0/1), MSB-first
// input order, t*R + j output order, with optional K-1 zero tail bits
// (helpers/test_helpers.h:54-60).  out must hold (8*n+tail)*R bits.
void EncodeFrameBits(const Encoder& e, const uint8_t* data, size_t n_bytes,
                     bool terminate, uint8_t* out) {
  uint64_t reg = 0;
  size_t pos = 0;
  if (e.has_lut) {
    uint32_t state = 0;  // reg >> 1 lives in [0, 2^(K-1))
    for (size_t i = 0; i < n_bytes; ++i) {
      size_t idx = (static_cast<size_t>(state) << 8) | data[i];
      uint64_t bits = e.lut_bits[idx];
      for (int b = 0; b < 8 * e.R; ++b) out[pos++] = (bits >> b) & 1;
      state = e.lut_next[idx];
    }
    // Seed the tail from the tracked state: bits above K-2 of the true
    // register are shifted past the K-bit mask before the next output, so
    // the newest K-1 bits are the whole story.
    reg = state;
  } else {
    for (size_t i = 0; i < n_bytes; ++i) {
      for (int b = 0; b < 8; ++b) {
        uint32_t bit = (data[i] >> (7 - b)) & 1;
        uint32_t o = e.StepBit(reg, bit);
        for (int j = 0; j < e.R; ++j) out[pos++] = (o >> j) & 1;
      }
    }
  }
  if (terminate) {
    for (int t = 0; t < e.K - 1; ++t) {
      uint32_t o = e.StepBit(reg, 0);
      for (int j = 0; j < e.R; ++j) out[pos++] = (o >> j) & 1;
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Encoder lifecycle.
// ---------------------------------------------------------------------------
void* vdt_encoder_create(int K, int R, const uint64_t* G) {
  // K > 64 would shift a 64-bit register by >= 64 (UB) and cannot be
  // represented by uint64 taps anyway.
  if (K < 2 || K > 64 || R < 1 || R > 8 || G == nullptr) return nullptr;
  return MakeEncoder(K, R, G);
}

void vdt_encoder_destroy(void* enc) { delete static_cast<Encoder*>(enc); }

// ---------------------------------------------------------------------------
// Batched encode: (B, n_bytes) data bytes -> (B, T*R) int16 soft symbols in
// {low, high}, T = 8*n_bytes (+ K-1 if terminate).  Frames shard over the
// thread pool (the reference's task-DP, run_benchmark.cpp:193-244).
// ---------------------------------------------------------------------------
void vdt_encode_soft_i16(void* enc, const uint8_t* data, size_t batch,
                         size_t n_bytes, int terminate, int16_t high,
                         int16_t low, int n_threads, int16_t* out) {
  const Encoder& e = *static_cast<Encoder*>(enc);
  size_t T = 8 * n_bytes + (terminate ? (e.K - 1) : 0);
  size_t frame_syms = T * e.R;
  ParallelFor(batch, n_threads, [&](size_t lo, size_t hi) {
    std::vector<uint8_t> bits(frame_syms);
    for (size_t f = lo; f < hi; ++f) {
      EncodeFrameBits(e, data + f * n_bytes, n_bytes, terminate != 0,
                      bits.data());
      int16_t* o = out + f * frame_syms;
      for (size_t i = 0; i < frame_syms; ++i) o[i] = bits[i] ? high : low;
    }
  });
}

// Raw encoded bits (uint8 0/1) variant, same layout.
void vdt_encode_bits(void* enc, const uint8_t* data, size_t batch,
                     size_t n_bytes, int terminate, int n_threads,
                     uint8_t* out) {
  const Encoder& e = *static_cast<Encoder*>(enc);
  size_t T = 8 * n_bytes + (terminate ? (e.K - 1) : 0);
  size_t frame_syms = T * e.R;
  ParallelFor(batch, n_threads, [&](size_t lo, size_t hi) {
    for (size_t f = lo; f < hi; ++f) {
      EncodeFrameBits(e, data + f * n_bytes, n_bytes, terminate != 0,
                      out + f * frame_syms);
    }
  });
}

// ---------------------------------------------------------------------------
// Fused encode -> BPSK modulate -> AWGN -> normalise -> quantise, the exact
// numeric chain of run_snr_ber.cpp:337-359:
//   EsNo_dB  = EbNo_dB - 10 log10(R)
//   sigma^2  = 10^(-(EsNo_dB+3)/10)
//   norm     = 1/sqrt(1 + sigma^2)
//   sym      = clamp(round(x*mag*norm + noise*mag*norm + mean), low, high)
// with x in {-1,+1}, mag = (high-low)/2, mean = (high+low)/2 and
// half-away-from-zero rounding (std::round).  Noise is mt19937 +
// std::normal_distribution like the reference (run_snr_ber.cpp:317, 348-350),
// seeded per frame as seed + frame_index so results are independent of the
// thread count.
// ---------------------------------------------------------------------------
void vdt_encode_awgn_quantize_i16(void* enc, const uint8_t* data,
                                  size_t batch, size_t n_bytes, int terminate,
                                  double EbNo_dB, int16_t high, int16_t low,
                                  uint64_t seed, int n_threads,
                                  int16_t* out) {
  const Encoder& e = *static_cast<Encoder*>(enc);
  size_t T = 8 * n_bytes + (terminate ? (e.K - 1) : 0);
  size_t frame_syms = T * e.R;
  const double EsNo_dB = EbNo_dB - 10.0 * std::log10(double(e.R));
  const double variance = std::pow(10.0, -(EsNo_dB + 3.0) / 10.0);
  const double sigma = std::sqrt(variance);
  const double mean = (double(high) + double(low)) / 2.0;
  const double mag = (double(high) - double(low)) / 2.0;
  const double norm = 1.0 / std::sqrt(1.0 + variance);
  const double scale = mag * norm;
  ParallelFor(batch, n_threads, [&](size_t lo, size_t hi) {
    std::vector<uint8_t> bits(frame_syms);
    for (size_t f = lo; f < hi; ++f) {
      EncodeFrameBits(e, data + f * n_bytes, n_bytes, terminate != 0,
                      bits.data());
      std::mt19937 rng(static_cast<uint32_t>(seed + f));
      std::normal_distribution<float> gauss(0.0f, float(sigma));
      int16_t* o = out + f * frame_syms;
      for (size_t i = 0; i < frame_syms; ++i) {
        float x = bits[i] ? 1.0f : -1.0f;
        double v = (double(x) + double(gauss(rng))) * scale + mean;
        double q = std::round(v);
        if (q > double(high)) q = double(high);
        if (q < double(low)) q = double(low);
        o[i] = static_cast<int16_t>(q);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Puncturing (helpers/puncture_code_helpers.h).
// ---------------------------------------------------------------------------

// Drop symbols where mask==0 (encode_punctured_data, :57-144).  Returns the
// number of kept symbols.  mask has length total (already tiled/phased).
size_t vdt_puncture_i16(const int16_t* syms, size_t total,
                        const uint8_t* mask, int16_t* out) {
  size_t n = 0;
  for (size_t i = 0; i < total; ++i) {
    if (mask[i]) out[n++] = syms[i];
  }
  return n;
}

// Re-inflate: insert `neutral` where mask==0 (decode_punctured_symbols,
// :17-55).  Returns the number of consumed kept symbols.
size_t vdt_depuncture_i16(const int16_t* kept, size_t n_kept, size_t total,
                          const uint8_t* mask, int16_t neutral,
                          int16_t* out) {
  size_t k = 0;
  for (size_t i = 0; i < total; ++i) {
    if (mask[i] && k < n_kept) {
      out[i] = kept[k++];
    } else {
      out[i] = neutral;
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Scoring (get_total_bit_errors, helpers/test_helpers.h:95-104).
// ---------------------------------------------------------------------------
uint64_t vdt_count_bit_errors_bytes(const uint8_t* a, const uint8_t* b,
                                    size_t n_bytes) {
  uint64_t total = 0;
  size_t i = 0;
  for (; i + 8 <= n_bytes; i += 8) {
    uint64_t x, y;
    std::memcpy(&x, a + i, 8);
    std::memcpy(&y, b + i, 8);
    total += __builtin_popcountll(x ^ y);
  }
  for (; i < n_bytes; ++i) {
    total += __builtin_popcount(static_cast<unsigned>(a[i] ^ b[i]));
  }
  return total;
}

// Element-wise mismatch count over 0/1 bit arrays.
uint64_t vdt_count_bit_errors_bits(const uint8_t* a, const uint8_t* b,
                                   size_t n_bits) {
  uint64_t total = 0;
  for (size_t i = 0; i < n_bits; ++i) total += (a[i] != b[i]) ? 1 : 0;
  return total;
}

// ---------------------------------------------------------------------------
// Random test data (generate_random_bytes, helpers/test_helpers.h:11-15)
// with a splittable-feeling per-call seed; mt19937 for parity with the
// reference harness.
// ---------------------------------------------------------------------------
void vdt_random_bytes(uint64_t seed, uint8_t* out, size_t n) {
  std::mt19937_64 rng(seed);
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v = rng();
    std::memcpy(out + i, &v, 8);
  }
  if (i < n) {
    uint64_t v = rng();
    std::memcpy(out + i, &v, n - i);
  }
}

int vdt_abi_version() { return 1; }

}  // extern "C"

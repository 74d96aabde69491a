// Benchmark oracle: time the reference library's update/chainback on a
// code that is NOT in its 8-entry registry (the registry harness,
// examples/run_benchmark.cpp, only iterates common_codes.h; its kernel
// templates themselves instantiate any K — README.md:13).  Gives a
// custom K=14 code a reference rate to compare against.
//
// Measurement mirrors the reference's own protocol
// (run_benchmark.cpp:250-283): duration-bounded repeat loop, separate
// ns timers around update and chainback, rates derived as
// symbols/update_ns and input_bits/chainback_ns (parse_benchmark.py:43-44).
//
// Usage: ref_bench_custom <mode:soft16|soft8|hard8> [block_bits=2048]
//                         [seconds=2.0]
// Prints one JSON record per valid AVX kernel.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <vector>
#include "viterbi/viterbi_branch_table.h"
#include "viterbi/viterbi_decoder_core.h"
#include "viterbi/x86/viterbi_decoder_avx_u16.h"
#include "viterbi/x86/viterbi_decoder_avx_u8.h"
#include "helpers/decode_type.h"

// A custom K=14 code: CodeSpec("K14-rand", 14, (0o21675, 0o27123)).
static constexpr size_t K = 14;
static constexpr size_t R = 2;

static int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::high_resolution_clock::now().time_since_epoch())
        .count();
}

template <class decoder_t, typename soft_t, typename error_t>
void bench(const char* simd_name, const char* mode,
           Decoder_Config<soft_t, error_t> config, const uint16_t* g,
           size_t block_bits, double seconds) {
    const size_t T = block_bits + K - 1;       // tail-terminated frame
    const size_t total_symbols = T * R;
    auto branch_table = ViterbiBranchTable<K, R, soft_t>(
        g, config.soft_decision_high, config.soft_decision_low);
    auto vitdec = ViterbiDecoder_Core<K, R, error_t, soft_t>(
        branch_table, config.decoder_config);
    vitdec.set_traceback_length(block_bits);

    std::mt19937 rng(777);
    std::uniform_int_distribution<int> dist(config.soft_decision_low,
                                            config.soft_decision_high);
    std::vector<soft_t> syms(total_symbols);
    for (auto& s : syms) s = (soft_t)dist(rng);
    std::vector<uint8_t> out(block_bits / 8);

    int64_t update_ns = 0, chainback_ns = 0;
    size_t iters = 0;
    const int64_t t_end = now_ns() + (int64_t)(seconds * 1e9);
    while (now_ns() < t_end) {
        vitdec.reset();
        int64_t t0 = now_ns();
        decoder_t::template update<uint64_t>(vitdec, syms.data(),
                                             total_symbols);
        int64_t t1 = now_ns();
        vitdec.chainback(out.data(), block_bits, 0);
        int64_t t2 = now_ns();
        update_ns += t1 - t0;
        chainback_ns += t2 - t1;
        iters++;
    }
    double sym_rate = (double)(iters * total_symbols) / (update_ns * 1e-9);
    double cb_rate = (double)(iters * block_bits) / (chainback_ns * 1e-9);
    printf("{\"name\": \"K14-rand\", \"K\": %zu, \"R\": %zu, "
           "\"decode_type\": \"%s\", \"simd_type\": \"%s\", "
           "\"iterations\": %zu, \"update_symbols_per_s\": %.4e, "
           "\"chainback_bits_per_s\": %.4e}\n",
           K, R, mode, simd_name, iters, sym_rate, cb_rate);
}

int main(int argc, char** argv) {
    std::string mode = argc > 1 ? argv[1] : "soft16";
    size_t block_bits = argc > 2 ? strtoul(argv[2], nullptr, 10) : 2048;
    double seconds = argc > 3 ? atof(argv[3]) : 2.0;
    // octal 21675, 27123
    static const uint16_t g[R] = {021675, 027123};
    if (mode == "soft16") {
        auto cfg = get_soft16_decoding_config(R);
        bench<ViterbiDecoder_AVX_u16<K, R>, int16_t, uint16_t>(
            "SIMD_AVX", "SOFT16", cfg, g, block_bits, seconds);
    } else if (mode == "soft8") {
        auto cfg = get_soft8_decoding_config(R);
        bench<ViterbiDecoder_AVX_u8<K, R>, int8_t, uint8_t>(
            "SIMD_AVX", "SOFT8", cfg, g, block_bits, seconds);
    } else if (mode == "hard8") {
        auto cfg = get_hard8_decoding_config(R);
        bench<ViterbiDecoder_AVX_u8<K, R>, int8_t, uint8_t>(
            "SIMD_AVX", "HARD8", cfg, g, block_bits, seconds);
    } else {
        fprintf(stderr, "unknown mode %s\n", mode.c_str());
        return 2;
    }
    return 0;
}

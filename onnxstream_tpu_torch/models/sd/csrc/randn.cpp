// randn_4_w_h of the reference (src/sd.cpp:1366-1385): std::mt19937 seeded
// with `seed` feeding std::normal_distribution<float>, `n` values in order.
// libstdc++'s own generators, so the values are the reference's; the Python
// copy in models/sd/rng.py (NormalDistributionFloat) gives the same bits.
#include <cstdint>
#include <random>

extern "C" void ostt_randn(uint32_t seed, int64_t n, float* out) {
    std::mt19937 gen(seed);
    std::normal_distribution<float> dist;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = dist(gen);
    }
}

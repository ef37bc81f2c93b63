// Native host-side Q40 dequantization: the f32 read of a Q40 tensor at
// load time (quants.deserialize_tensor), the port's copy of the JAX
// package's q40_dequant_f32 with its C ABI for ctypes.
//
// Layout: file blocks (reference src/quants.hpp:17-20): per 32 values, a
// 2-byte f16 scale + 16 bytes, low nibble = value j, high = value j+16.
// dequant = (nibble - 8) * scale in f32, the numpy version's arithmetic.

#include <cstdint>
#include <cstring>

namespace {

// f16 -> f32 without F16C intrinsics (bit manipulation, handles subnormals)
inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {
            // subnormal, mant * 2^-24: normalize to 1.f * 2^(-14 - shift),
            // a biased f32 exponent of 127 - 14 - shift = 113 - shift (the
            // JAX package's copy writes 112, half the value)
            int shift = 0;
            while (!(mant & 0x400)) { mant <<= 1; shift++; }
            mant &= 0x3FF;
            bits = sign | ((113 - shift) << 23) | (mant << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000 | (mant << 13);
    } else {
        bits = sign | ((exp + 112) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

constexpr int QK = 32;
constexpr int BLOCK_BYTES = 2 + QK / 2;  // f16 scale + 16 nibble bytes

}  // namespace

extern "C" {

// Dequantize n_blocks Q40 file blocks to f32 (row-major stream).
// out must hold n_blocks * 32 floats.
void q40_dequant_f32(const uint8_t* blocks, int64_t n_blocks, float* out) {
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* blk = blocks + b * BLOCK_BYTES;
        uint16_t h;
        std::memcpy(&h, blk, 2);
        const float scale = f16_to_f32(h);
        const uint8_t* qs = blk + 2;
        float* o = out + b * QK;
        for (int j = 0; j < QK / 2; j++) {
            o[j] = (float)((int)(qs[j] & 0xF) - 8) * scale;
            o[j + QK / 2] = (float)((int)(qs[j] >> 4) - 8) * scale;
        }
    }
}

}  // extern "C"

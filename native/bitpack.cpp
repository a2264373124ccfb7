// Native host-side runtime for h264lab_tpu: variable-length bit packing and
// NAL emulation-prevention escaping.
//
// These are the two host-side hot paths of the encoder (the device produces
// dense (value, nbits) symbol arrays; the host packs them into RBSP bytes
// and escapes them into NAL payloads). They are the C++ equivalents of the
// reference's bit cache (src/h264-lab.h:2688-2772) and nal_put_esc
// (src/h264-lab.h:3952-3977), redesigned for bulk symbol streams instead of
// per-syntax-element calls.
//
// Build: make -C native        (produces libh264lab_native.so)

#include <cstdint>
#include <cstring>

extern "C" {

// Escape an RBSP payload: insert 0x03 after any 00 00 pair followed by a
// byte <= 3. Returns output length, or -1 if out_cap is too small.
long h264lab_escape_rbsp(const uint8_t* in, long n, uint8_t* out,
                         long out_cap) {
    long o = 0;
    int zeros = 0;
    for (long i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) {
            if (o + 2 > out_cap) return -1;
            out[o++] = 3;
            zeros = 0;
        }
        if (o + 1 > out_cap) return -1;
        out[o++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return o;
}

// Pack (value, nbits) symbol pairs MSB-first into bytes. Entries with
// nbits == 0 are skipped. The tail is zero-padded to a byte boundary.
// Returns the number of bytes written, or -1 on overflow.
long h264lab_pack_bits(const uint32_t* vals, const uint8_t* lens, long n,
                       uint8_t* out, long out_cap) {
    uint64_t acc = 0;  // bits accumulate at the top (MSB-first)
    int acc_bits = 0;
    long o = 0;
    for (long i = 0; i < n; i++) {
        int nb = lens[i];
        if (nb == 0) continue;
        acc = (acc << nb) | (uint64_t)(vals[i] & (0xFFFFFFFFu >> (32 - nb)));
        acc_bits += nb;
        while (acc_bits >= 8) {
            if (o >= out_cap) return -1;
            out[o++] = (uint8_t)(acc >> (acc_bits - 8));
            acc_bits -= 8;
        }
        // keep only live bits to avoid overflow on the next shift
        acc &= (acc_bits ? ((1ULL << acc_bits) - 1) : 0);
    }
    if (acc_bits > 0) {
        if (o >= out_cap) return -1;
        out[o++] = (uint8_t)(acc << (8 - acc_bits));
    }
    return o;
}

}  // extern "C"

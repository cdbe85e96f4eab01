// genomics_native: C++ fast paths for the data pipeline (the port's own copy
// of genomics_lm_tpu/native/genomics_native.cpp, the same C ABI).
//
// Host code, not a device kernel: it runs where the data is prepared.
//
//   - codon tokenization (DNA bytes -> token ids, ambiguity-aware)
//   - reverse complement
//   - SHA-256 (exact-duplicate scanning without Python hashing overhead)
//   - minhash signatures + greedy clustering (stand-in for MMseqs2
//     easy-cluster in non-scientific preparations; the agreement of 64
//     minhashes ESTIMATES the shingle Jaccard)
//
// Exposed as a plain C ABI consumed via ctypes. Built at first use by
// genomics_lm_torch/kernels/build.py::build_host (g++ -O3 -fPIC -shared
// -std=c++17) into genomics_lm_torch/kernels/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// --- codon tokenization -----------------------------------------------------
// Vocabulary contract: ids 4..67 are the 64 codons in lexical A<C<G<T order
// (reference codon_tokenize.py:29-44). Ambiguous codons emit -1.

static inline int base_code(unsigned char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': case 'U': case 'u': return 3;
        default: return -1;
    }
}

// dna[0..len) -> out[0..len/3); returns number of codons written.
int tokenize_codons(const char* dna, int64_t len, int32_t* out) {
    int64_t n_codons = len / 3;
    for (int64_t i = 0; i < n_codons; ++i) {
        int b0 = base_code(dna[3 * i]);
        int b1 = base_code(dna[3 * i + 1]);
        int b2 = base_code(dna[3 * i + 2]);
        out[i] = (b0 < 0 || b1 < 0 || b2 < 0)
                     ? -1
                     : 4 + b0 * 16 + b1 * 4 + b2;
    }
    return (int)n_codons;
}

// --- reverse complement -----------------------------------------------------

void reverse_complement(const char* in, int64_t len, char* out) {
    for (int64_t i = 0; i < len; ++i) {
        char c = in[len - 1 - i];
        char r;
        switch (c) {
            case 'A': r = 'T'; break;
            case 'T': r = 'A'; break;
            case 'C': r = 'G'; break;
            case 'G': r = 'C'; break;
            case 'a': r = 't'; break;
            case 't': r = 'a'; break;
            case 'c': r = 'g'; break;
            case 'g': r = 'c'; break;
            default: r = c; break;
        }
        out[i] = r;
    }
}

// --- SHA-256 ----------------------------------------------------------------

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

void sha256(const uint8_t* data, int64_t len, uint8_t out[32]) {
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    int64_t total_bits = len * 8;
    // message + 0x80 pad + zeros + 8-byte length, multiple of 64
    int64_t padded = ((len + 8) / 64 + 1) * 64;
    std::vector<uint8_t> msg(padded, 0);
    std::memcpy(msg.data(), data, (size_t)len);
    msg[len] = 0x80;
    for (int i = 0; i < 8; ++i)
        msg[padded - 1 - i] = (uint8_t)((total_bits >> (8 * i)) & 0xff);

    uint32_t w[64];
    for (int64_t chunk = 0; chunk < padded; chunk += 64) {
        const uint8_t* p = msg.data() + chunk;
        for (int i = 0; i < 16; ++i)
            w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
                   (uint32_t)p[4 * i + 2] << 8 | (uint32_t)p[4 * i + 3];
        for (int i = 16; i < 64; ++i) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
    for (int i = 0; i < 8; ++i) {
        out[4 * i] = (uint8_t)(h[i] >> 24);
        out[4 * i + 1] = (uint8_t)(h[i] >> 16);
        out[4 * i + 2] = (uint8_t)(h[i] >> 8);
        out[4 * i + 3] = (uint8_t)(h[i]);
    }
}

// --- minhash signatures + greedy clustering ---------------------------------

static inline uint64_t mix64(uint64_t x) {
    // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

// Per-sequence minhash signature over k-mer shingles using n_hashes
// xor-seeded hash functions. seqs are concatenated; offsets has n+1 entries.
void minhash_signatures(const char* concat, const int64_t* offsets, int n_seqs,
                        int k, int n_hashes, uint64_t* out /* n_seqs*n_hashes */) {
    for (int s = 0; s < n_seqs; ++s) {
        const char* seq = concat + offsets[s];
        int64_t len = offsets[s + 1] - offsets[s];
        uint64_t* sig = out + (int64_t)s * n_hashes;
        for (int j = 0; j < n_hashes; ++j) sig[j] = UINT64_MAX;
        if (len < k) continue;
        for (int64_t pos = 0; pos + k <= len; ++pos) {
            // FNV-1a over the shingle
            uint64_t base = 1469598103934665603ULL;
            for (int i = 0; i < k; ++i)
                base = (base ^ (uint8_t)seq[pos + i]) * 1099511628211ULL;
            for (int j = 0; j < n_hashes; ++j) {
                uint64_t v = mix64(base ^ ((uint64_t)j * 0xc2b2ae3d27d4eb4fULL));
                if (v < sig[j]) sig[j] = v;
            }
        }
    }
}

// Greedy clustering on signatures: sequence joins the first existing cluster
// representative whose estimated jaccard >= min_jaccard, else founds a new
// cluster. labels_out[i] = representative index. Returns cluster count.
int minhash_greedy_cluster(const uint64_t* sigs, int n_seqs, int n_hashes,
                           double min_jaccard, int32_t* labels_out) {
    std::vector<int> reps;
    reps.reserve(256);
    for (int s = 0; s < n_seqs; ++s) {
        const uint64_t* sig = sigs + (int64_t)s * n_hashes;
        int assigned = -1;
        for (int r : reps) {
            const uint64_t* rep_sig = sigs + (int64_t)r * n_hashes;
            int agree = 0;
            for (int j = 0; j < n_hashes; ++j)
                if (sig[j] == rep_sig[j]) ++agree;
            if ((double)agree / n_hashes >= min_jaccard) {
                assigned = r;
                break;
            }
        }
        if (assigned < 0) {
            reps.push_back(s);
            assigned = s;
        }
        labels_out[s] = assigned;
    }
    return (int)reps.size();
}

}  // extern "C"

// Native BPE encoder: the host-side tokenize hot path.
//
// Same algorithm as the Python Tokenizer.encode_plain (and the reference's
// src/tokenizer.cpp:170-292): UTF-8 codepoint split with byte fallback (+3),
// then greedy highest-score adjacent-pair merging, leftmost on ties. The
// Python loop rescans every pair after each merge, O(n^2); here the pairs
// wait in a heap and a merge re-scores only its two neighbours, O(n log n),
// with the same merges in the same order.
//
// C ABI for ctypes, the JAX package's (bpe_new / bpe_encode / bpe_free)
// plus bpe_encode_after, which starts the token list with a given token
// (the dummy-prefix space) before the split of the text, as the Python
// encode does. Prefixing a literal space to the text instead, as the JAX
// package's wrapper does, glues the space to a leading UTF-8 continuation
// byte. A tokenizer handle owns copies of the vocab.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
    std::vector<std::string> vocab;
    std::vector<float> scores;
    std::unordered_map<std::string, int32_t> index;  // first-wins
};

}  // namespace

extern "C" {

// vocab_bytes: concatenated token byte strings; offsets: n+1 prefix offsets.
void* bpe_new(const uint8_t* vocab_bytes, const int64_t* offsets,
              const float* scores, int32_t n) {
    Bpe* b = new Bpe();
    b->vocab.reserve(n);
    b->scores.assign(scores, scores + n);
    for (int32_t i = 0; i < n; i++) {
        b->vocab.emplace_back((const char*)vocab_bytes + offsets[i],
                              (size_t)(offsets[i + 1] - offsets[i]));
        b->index.emplace(b->vocab.back(), i);
    }
    return b;
}

void bpe_free(void* handle) { delete (Bpe*)handle; }

// Encode text to token ids after the token `first` (-1: none), which takes
// part in the merges. Returns the token count (<= len + 1, the size the
// caller gives out), or -1 when a byte-fallback id lies past the vocab (a
// vocab without the 256 byte pieces). No BOS/EOS — the Python wrapper adds
// those.
int32_t bpe_encode_after(void* handle, int32_t first, const uint8_t* text,
                         int64_t len, int32_t* out) {
    Bpe* b = (Bpe*)handle;
    std::vector<int32_t> tokens;
    tokens.reserve(len + 1);
    if (first >= 0) tokens.push_back(first);

    // UTF-8 codepoint split with byte fallback (+3)
    int64_t i = 0;
    std::string piece;
    while (i < len) {
        int64_t j = i + 1;
        while (j < len && (text[j] & 0xC0) == 0x80 && (j - i) < 4) j++;
        piece.assign((const char*)text + i, (size_t)(j - i));
        auto it = b->index.find(piece);
        if (it != b->index.end()) {
            tokens.push_back(it->second);
        } else {
            for (int64_t k = i; k < j; k++) tokens.push_back((int32_t)text[k] + 3);
        }
        i = j;
    }

    // Greedy merging: repeatedly merge the adjacent pair whose
    // concatenation is a piece with the highest score above -1e10, the
    // leftmost on ties (what a left-to-right scan with a strict > picks).
    // The pairs wait in a heap ordered by (score, position): a merge keeps
    // its left node, so node indices stay in text order, and only the two
    // pairs around the merged node are new. A heap entry whose nodes
    // changed since it was pushed is stale and skipped. O(n log n) instead
    // of the scan's O(n^2), the same merges in the same order.
    const int64_t n = (int64_t)tokens.size();
    for (int32_t t : tokens)
        if (t < 0 || t >= (int32_t)b->vocab.size()) return -1;
    std::vector<int32_t> id(tokens), prev(n), next(n);
    std::vector<uint32_t> version(n, 0);
    for (int64_t k = 0; k < n; k++) {
        prev[k] = (int32_t)k - 1;
        next[k] = k + 1 < n ? (int32_t)k + 1 : -1;
    }
    struct Cand {
        float score;
        int32_t left, right, merged;
        uint32_t vl, vr;
    };
    auto worse = [](const Cand& a, const Cand& c) {
        return a.score < c.score || (a.score == c.score && a.left > c.left);
    };
    std::priority_queue<Cand, std::vector<Cand>, decltype(worse)> heap(worse);
    std::string merged;
    auto push = [&](int32_t l, int32_t r) {
        if (l < 0 || r < 0) return;
        merged = b->vocab[id[l]];
        merged += b->vocab[id[r]];
        auto it = b->index.find(merged);
        if (it == b->index.end()) return;
        const float score = b->scores[it->second];
        if (!((double)score > -1e10)) return;  // the scan's initial best
        heap.push(Cand{score, l, r, it->second, version[l], version[r]});
    };
    for (int64_t k = 0; k + 1 < n; k++) push((int32_t)k, (int32_t)k + 1);
    std::vector<bool> alive(n, true);
    while (!heap.empty()) {
        const Cand c = heap.top();
        heap.pop();
        if (!alive[c.left] || !alive[c.right] || next[c.left] != c.right || version[c.left] != c.vl ||
            version[c.right] != c.vr)
            continue;  // stale
        id[c.left] = c.merged;
        version[c.left]++;
        alive[c.right] = false;
        next[c.left] = next[c.right];
        if (next[c.left] >= 0) prev[next[c.left]] = c.left;
        push(prev[c.left], c.left);
        push(c.left, next[c.left]);
    }
    tokens.clear();
    for (int32_t k = n > 0 ? 0 : -1; k >= 0; k = next[k]) tokens.push_back(id[k]);

    std::memcpy(out, tokens.data(), tokens.size() * sizeof(int32_t));
    return (int32_t)tokens.size();
}

// Encode text to token ids (no BOS/EOS/dummy prefix).
int32_t bpe_encode(void* handle, const uint8_t* text, int64_t len,
                   int32_t* out) {
    return bpe_encode_after(handle, -1, text, len, out);
}

}  // extern "C"

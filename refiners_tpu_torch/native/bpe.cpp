// Native BPE merge engine for the CLIP tokenizer.
//
// The Python side handles text cleanup, regex splitting and the byte→unicode
// mapping; this library runs the O(n²) pair-merge loop, which dominates
// tokenization time for long prompts and batch serving.
//
// C ABI (ctypes):
//   bpe_new()                      → handle
//   bpe_add_token(h, bytes, n, id) → register a vocab token (byte string → id)
//   bpe_add_merge(h, a, na, b, nb, rank) → register a merge pair with rank
//   bpe_encode(h, word, n, out, out_cap) → number of ids written
//   bpe_free(h)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        return std::hash<std::string>()(p.first) * 1000003u ^ std::hash<std::string>()(p.second);
    }
};

struct BPE {
    std::unordered_map<std::string, int32_t> vocab;
    std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash> ranks;
    std::unordered_map<std::string, std::vector<int32_t>> cache;
};

}  // namespace

extern "C" {

void* bpe_new() { return new BPE(); }

void bpe_free(void* handle) { delete static_cast<BPE*>(handle); }

void bpe_add_token(void* handle, const char* bytes, int32_t n, int32_t id) {
    static_cast<BPE*>(handle)->vocab.emplace(std::string(bytes, n), id);
}

void bpe_add_merge(void* handle, const char* a, int32_t na, const char* b, int32_t nb, int32_t rank) {
    static_cast<BPE*>(handle)->ranks.emplace(
        std::make_pair(std::string(a, na), std::string(b, nb)), rank);
}

// Encode one pre-split word (raw bytes, WITHOUT the </w> suffix — it is
// appended here to the last symbol, matching the CLIP convention).
int32_t bpe_encode(void* handle, const char* word, int32_t n, int32_t* out, int32_t out_cap) {
    BPE& bpe = *static_cast<BPE*>(handle);
    if (n == 0) return 0;

    const std::string key(word, n);
    auto cached = bpe.cache.find(key);
    if (cached != bpe.cache.end()) {
        int32_t count = 0;
        for (int32_t id : cached->second) {
            if (count >= out_cap) break;
            out[count++] = id;
        }
        return count;
    }

    // initial symbols: one per byte, last byte carries "</w>"
    std::vector<std::string> symbols;
    symbols.reserve(n);
    for (int32_t i = 0; i < n; i++) symbols.emplace_back(1, word[i]);
    symbols.back() += "</w>";

    while (symbols.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < symbols.size(); i++) {
            auto it = bpe.ranks.find({symbols[i], symbols[i + 1]});
            if (it != bpe.ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        // merge ALL occurrences of the best pair left-to-right (CLIP semantics)
        const std::string first = symbols[best_i];
        const std::string second = symbols[best_i + 1];
        std::vector<std::string> merged;
        merged.reserve(symbols.size());
        for (size_t i = 0; i < symbols.size();) {
            if (i + 1 < symbols.size() && symbols[i] == first && symbols[i + 1] == second) {
                merged.emplace_back(first + second);
                i += 2;
            } else {
                merged.emplace_back(symbols[i]);
                i += 1;
            }
        }
        symbols.swap(merged);
    }

    std::vector<int32_t> ids;
    ids.reserve(symbols.size());
    for (const auto& sym : symbols) {
        auto it = bpe.vocab.find(sym);
        ids.push_back(it != bpe.vocab.end() ? it->second : -1);
    }
    bpe.cache.emplace(key, ids);

    int32_t count = 0;
    for (int32_t id : ids) {
        if (count >= out_cap) break;
        out[count++] = id;
    }
    return count;
}

// Batched entry point: words are concatenated in `data`, word i spanning
// offsets[i]..offsets[i+1]. Amortizes the FFI crossing over the whole prompt.
int32_t bpe_encode_batch(
    void* handle,
    const char* data,
    const int32_t* offsets,
    int32_t num_words,
    int32_t* out,
    int32_t out_cap) {
    int32_t total = 0;
    for (int32_t i = 0; i < num_words; i++) {
        total += bpe_encode(
            handle, data + offsets[i], offsets[i + 1] - offsets[i], out + total, out_cap - total);
    }
    return total;
}

}  // extern "C"

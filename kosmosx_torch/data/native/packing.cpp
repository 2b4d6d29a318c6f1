// Native host-side data-path kernel for kosmosx_torch (the port's own copy
// of kosmosx_tpu/data/native/packing.cpp).
//
// The reference's data pipeline gets its speed from native dependencies
// (HF `datasets` -> Arrow C++, HF tokenizers -> Rust; the reference's
// train.py:416-483).  This framework keeps the same contract but owns the
// hot host-side op: concat-and-chunk token packing (the reference's
// `group_texts`, its train.py:444-462).  Exposed as a plain C ABI consumed
// via ctypes (no pybind11); `kosmosx_torch/data/native/__init__.py` builds
// it on demand with g++ and falls back to numpy when unavailable.
//
// The function is single-call, bounded, and allocation-free: callers pass
// pre-sized numpy buffers, so the GIL can be released around the call.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Pack tokenized documents into fixed-length blocks.
//
// Semantics (must match the numpy fallback + reference group_texts):
// stream = carry ++ concat(doc_i ++ [eos_id] for each doc); emit
// floor(len(stream)/seq_len) blocks of seq_len; the remainder becomes the
// new carry (returned via tail/tail_len, capacity seq_len-1).
//
// tokens      flat int32 array: all docs back-to-back
// doc_lens    per-doc lengths (n_docs entries, sum == len(tokens))
// carry       leftover tokens from the previous call (carry_len < seq_len)
// out         caller buffer of max_blocks*seq_len int32
// tail        caller buffer of seq_len int32; receives the new remainder
//
// Returns the number of blocks written (<= max_blocks); if the input would
// produce more than max_blocks blocks, returns -1 and writes nothing (the
// caller sizes max_blocks = (total+carry)/seq_len exactly, so this only
// trips on caller error).
int64_t ksx_pack_blocks(const int32_t* tokens, const int64_t* doc_lens,
                        int64_t n_docs, int32_t eos_id, int64_t seq_len,
                        const int32_t* carry, int64_t carry_len,
                        int32_t* out, int64_t max_blocks,
                        int32_t* tail, int64_t* tail_len) {
  if (seq_len <= 0 || carry_len < 0 || carry_len >= seq_len) return -1;
  int64_t total = carry_len;
  for (int64_t d = 0; d < n_docs; ++d) total += doc_lens[d] + 1;  // +EOS
  const int64_t n_blocks = total / seq_len;
  if (n_blocks > max_blocks) return -1;

  // cursor over the logical stream; flush to `out` block-by-block
  int64_t filled = 0;       // tokens in the current (partial) block
  int64_t blocks = 0;
  int32_t* dst = out;
  auto push = [&](const int32_t* src, int64_t n) {
    while (n > 0) {
      const int64_t room = seq_len - filled;
      const int64_t take = std::min(room, n);
      int32_t* base = (blocks < n_blocks) ? dst + blocks * seq_len : tail;
      std::memcpy(base + filled, src, static_cast<size_t>(take) * 4);
      filled += take;
      src += take;
      n -= take;
      if (filled == seq_len) {
        ++blocks;
        filled = 0;
      }
    }
  };
  push(carry, carry_len);
  const int32_t* p = tokens;
  for (int64_t d = 0; d < n_docs; ++d) {
    push(p, doc_lens[d]);
    p += doc_lens[d];
    push(&eos_id, 1);
  }
  *tail_len = filled;
  return blocks;
}

}  // extern "C"

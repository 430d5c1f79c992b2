// Native host-side data runtime of the PyTorch/CUDA port: its own copy of
// the JAX package's native/dataloader.cpp, the same C API and the same
// arithmetic, so the two give the same bytes (tests/test_torch_native_loader.py).
//
// The reference's data layer is `torchvision.datasets.CIFAR10` + torch
// `DataLoader` (ddp_guide_cifar10/ddp_init.py:42-54): Python orchestration
// over torchvision/torch *native* decode + collate kernels. Here the
// per-step host work (index gather, u8->f32 normalize, batch assembly) runs
// in multithreaded C++, with a prefetching pipeline so batch N+1 is
// assembled while the card runs step N; data/loader.device_prefetch then
// stages it through pinned memory on a side stream.
//
// Exposed as a plain C API consumed via ctypes (native/build.py compiles it
// with g++ at first use).
//
// Functions:
//   ndp_decode_cifar10_bin  — decode the cifar-10-batches-bin record format
//                             (1 label byte + 3072 CHW bytes) to NHWC float32
//                             normalized, plus int32 labels.
//   ndp_gather_normalize_u8 — fused gather+normalize: rows of a uint8 dataset
//                             selected by an index vector, emitted as float32
//                             (x/255 - mean)/std. One pass over memory.
//   ndp_gather_f32/i32      — plain multithreaded row gathers.
//   ndp_loader_*            — a prefetching batch loader: worker thread
//                             assembles batches (from a Python-provided epoch
//                             permutation, preserving the framework's seeded
//                             shuffle semantics) into a bounded ring buffer.
//   ndp_tokenize_hash       — data/imdb.HashTokenizer's hot loop.
//   ndp_wordpiece_*         — data/wordpiece.WordPieceTokenizer's matcher.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------- threading
static void parallel_for(int64_t n, int n_threads,
                         const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || n < 2) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// Thread churn guard: spawning/joining threads costs ~100µs; below this much
// moved memory a single thread wins (worst case otherwise: 8 threads for a
// few-hundred-byte label gather).
static int effective_threads(int64_t work_bytes, int n_threads) {
  return work_bytes < (int64_t)1 << 18 ? 1 : n_threads;
}

// Same guard for COMPUTE-bound kernels (tokenization does hash probes per
// byte, ~50 MB/s vs memcpy's GB/s): far fewer bytes amortize the spawn
// cost, so the threshold is 16 KB instead of 256 KB — a typical per-step
// text batch fans out instead of running single-threaded.
static int effective_threads_compute(int64_t work_bytes, int n_threads) {
  return work_bytes < (int64_t)1 << 14 ? 1 : n_threads;
}

extern "C" {

// ------------------------------------------------------------------ decode
// cifar-10-batches-bin record: [label u8][R 32x32][G 32x32][B 32x32].
// Emits NHWC float32 (x/255 - mean)/std and int32 labels.
// Normalization matches numpy's float32 op order bit-exactly:
// ((x / 255.0f) - mean) / std — golden-parity tests assert equality.
static inline float norm_px(uint8_t v, float mean, float std_) {
  return ((float)v / 255.0f - mean) / std_;
}

void ndp_decode_cifar10_bin(const uint8_t* records, int64_t n_records,
                            float mean, float std_, float* out_images,
                            int32_t* out_labels, int n_threads) {
  n_threads = effective_threads(n_records * 3073, n_threads);
  parallel_for(n_records, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = records + i * 3073;
      out_labels[i] = (int32_t)rec[0];
      const uint8_t* chw = rec + 1;
      float* img = out_images + i * 3072;
      for (int h = 0; h < 32; ++h)
        for (int w = 0; w < 32; ++w) {
          int64_t hw = h * 32 + w;
          float* px = img + hw * 3;
          px[0] = norm_px(chw[hw], mean, std_);
          px[1] = norm_px(chw[1024 + hw], mean, std_);
          px[2] = norm_px(chw[2048 + hw], mean, std_);
        }
    }
  });
}

// ----------------------------------------------------------------- gathers
void ndp_gather_normalize_u8(const uint8_t* src, const int64_t* idx,
                             int64_t n_idx, int64_t row_elems, float mean,
                             float std_, float* dst, int n_threads) {
  n_threads = effective_threads(n_idx * row_elems, n_threads);
  parallel_for(n_idx, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = src + idx[i] * row_elems;
      float* d = dst + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j)
        d[j] = norm_px(s[j], mean, std_);
    }
  });
}

void ndp_gather_f32(const float* src, const int64_t* idx, int64_t n_idx,
                    int64_t row_elems, float* dst, int n_threads) {
  n_threads = effective_threads(n_idx * row_elems * 4, n_threads);
  parallel_for(n_idx, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      std::memcpy(dst + i * row_elems, src + idx[i] * row_elems,
                  row_elems * sizeof(float));
  });
}

void ndp_gather_i32(const int32_t* src, const int64_t* idx, int64_t n_idx,
                    int64_t row_elems, int32_t* dst, int n_threads) {
  n_threads = effective_threads(n_idx * row_elems * 4, n_threads);
  parallel_for(n_idx, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      std::memcpy(dst + i * row_elems, src + idx[i] * row_elems,
                  row_elems * sizeof(int32_t));
  });
}

// ------------------------------------------------------------- prefetcher
// Assembles (x, y) batches on a worker thread into a bounded queue. The
// dataset stays uint8 (or f32) in place; each batch is gathered (+normalized
// when u8) by the worker so the consumer only ever copies a ready buffer.
struct NdpLoader {
  // dataset (borrowed pointers — Python keeps the arrays alive)
  const uint8_t* x_u8 = nullptr;  // either u8 (fused normalize) ...
  const float* x_f32 = nullptr;   // ... or f32 passthrough
  const int32_t* y = nullptr;
  int64_t row_elems = 0, y_elems = 0;
  float mean = 0.f, std_ = 1.f;
  // epoch order (owned copy)
  std::vector<int64_t> order;
  int64_t batch = 0, n_batches = 0, next_emit = 0;
  int n_threads = 1;

  struct Slot {
    std::vector<float> x;
    std::vector<int32_t> y;
  };
  std::queue<Slot> ready;
  size_t depth = 2;
  std::mutex mu;
  std::condition_variable cv_space, cv_item;
  std::atomic<bool> stop{false};
  // pipeline health counters (read via ndp_loader_stats): batches handed to
  // the consumer, and how long the consumer sat blocked waiting for the
  // worker — the "is assembly the bottleneck" number, measured natively.
  std::atomic<long long> emitted{0};
  std::atomic<long long> consumer_wait_ns{0};
  std::thread worker;

  void run() {
    for (int64_t b = 0; b < n_batches && !stop.load(); ++b) {
      Slot s;
      s.x.resize(batch * row_elems);
      s.y.resize(batch * y_elems);
      const int64_t* idx = order.data() + b * batch;
      if (x_u8)
        ndp_gather_normalize_u8(x_u8, idx, batch, row_elems, mean, std_,
                                s.x.data(), n_threads);
      else
        ndp_gather_f32(x_f32, idx, batch, row_elems, s.x.data(), n_threads);
      ndp_gather_i32(y, idx, batch, y_elems, s.y.data(), n_threads);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < depth || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(s));
      cv_item.notify_one();
    }
  }
};

void* ndp_loader_create(const uint8_t* x_u8, const float* x_f32,
                        const int32_t* y, int64_t row_elems, int64_t y_elems,
                        float mean, float std_, const int64_t* order,
                        int64_t n_order, int64_t batch, int64_t depth,
                        int n_threads) {
  auto* L = new NdpLoader();
  L->x_u8 = x_u8;
  L->x_f32 = x_f32;
  L->y = y;
  L->row_elems = row_elems;
  L->y_elems = y_elems;
  L->mean = mean;
  L->std_ = std_;
  L->order.assign(order, order + n_order);
  L->batch = batch;
  L->n_batches = n_order / batch;
  L->depth = depth < 1 ? 1 : (size_t)depth;
  L->n_threads = n_threads;
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until a batch is ready; copies it out. Returns 1 on success, 0 when
// the epoch is exhausted.
int ndp_loader_next(void* loader, float* out_x, int32_t* out_y) {
  auto* L = (NdpLoader*)loader;
  if (L->next_emit >= L->n_batches) return 0;
  auto t0 = std::chrono::steady_clock::now();
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_item.wait(lk, [&] { return !L->ready.empty(); });
  NdpLoader::Slot s = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_one();
  lk.unlock();
  L->consumer_wait_ns.fetch_add(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - t0)
          .count());
  std::memcpy(out_x, s.x.data(), s.x.size() * sizeof(float));
  std::memcpy(out_y, s.y.data(), s.y.size() * sizeof(int32_t));
  L->next_emit++;
  L->emitted.fetch_add(1);
  return 1;
}

// Pipeline counters since create: out[0] = batches emitted, out[1] = total
// nanoseconds the consumer spent blocked in ndp_loader_next, out[2] = the
// epoch's total batch count. Safe to call at any time, including after
// exhaustion.
void ndp_loader_stats(void* loader, long long* out) {
  auto* L = (NdpLoader*)loader;
  out[0] = L->emitted.load();
  out[1] = L->consumer_wait_ns.load();
  out[2] = (long long)L->n_batches;
}

void ndp_loader_destroy(void* loader) {
  auto* L = (NdpLoader*)loader;
  {
    // under the lock: a store between the worker's predicate check and its
    // wait would otherwise be a lost wake-up, and the join below would hang
    // (an epoch abandoned mid-way, e.g. by a preempted loop, lands here)
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_space.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

// ------------------------------------------------------------- tokenizer
// Hash tokenizer (parity with data/imdb.HashTokenizer, the framework's
// IMDb front end standing in for DistilBertTokenizerFast,
// ddp_powersgd_distillBERT_IMDb/ddp_init.py:74-77): texts arrive as
// PRE-LOWERCASED UTF-8 bytes (lowercasing is Unicode-aware and stays in
// Python) with row offsets; each row splits on ASCII whitespace (the byte
// subset of Python str.split()'s separators), words FNV-1a-hash into
// [3, vocab), wrapped in [CLS]=1 / [SEP]=2, zero-padded to max_len.
// Token-for-token equal to the Python implementation for any text whose
// *whitespace* is ASCII (non-ASCII word bytes hash identically).

static inline bool ndp_is_space(uint8_t b) {
  // ' ' \t \n \v \f \r and the C0 separators \x1c-\x1f — exactly the
  // single-byte characters Python's str.split() treats as whitespace
  return b == 0x20 || (b >= 0x09 && b <= 0x0d) || (b >= 0x1c && b <= 0x1f);
}

void ndp_tokenize_hash(const uint8_t* bytes, const int64_t* offsets,
                       int64_t n_texts, int32_t vocab_size, int32_t max_len,
                       int n_threads, int32_t* ids_out, int32_t* mask_out) {
  int64_t total = n_texts ? offsets[n_texts] : 0;
  parallel_for(n_texts, effective_threads_compute(total, n_threads),
               [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* p = bytes + offsets[i];
      const uint8_t* end = bytes + offsets[i + 1];
      int32_t* ids = ids_out + i * max_len;
      int32_t* mask = mask_out + i * max_len;
      std::memset(ids, 0, (size_t)max_len * sizeof(int32_t));
      std::memset(mask, 0, (size_t)max_len * sizeof(int32_t));
      int32_t pos = 0;
      ids[pos++] = 1;  // [CLS]
      const int32_t max_words = max_len - 2;
      int32_t words = 0;
      while (p < end && words < max_words) {
        while (p < end && ndp_is_space(*p)) ++p;
        if (p >= end) break;
        uint32_t h = 2166136261u;  // FNV-1a offset basis
        while (p < end && !ndp_is_space(*p)) {
          h = (h ^ (uint32_t)*p) * 16777619u;
          ++p;
        }
        ids[pos++] = 3 + (int32_t)(h % (uint32_t)(vocab_size - 3));
        ++words;
      }
      ids[pos++] = 2;  // [SEP]
      for (int32_t j = 0; j < pos; ++j) mask[j] = 1;
    }
  });
}

// ----------------------------------------------------- WordPiece matcher
// Greedy longest-match WordPiece (parity with data/wordpiece
// .WordPieceTokenizer, the first-party DistilBertTokenizerFast equivalent,
// ddp_powersgd_distillBERT_IMDb/ddp_init.py:74-77). The Unicode-aware text
// normalization (clean / CJK spacing / lowercase / NFD accent strip /
// punctuation split) stays in Python where it is correct by construction;
// this is the hot inner loop — probing word substrings against the vocab
// hash table. Probes are byte-level: vocab entries are valid UTF-8, so a
// probe can only succeed on a character boundary, and among succeeding
// probes byte-longest == char-longest. Token-for-token equal to the Python
// matcher for all input (asserted in tests/test_torch_native_loader.py).

struct NdpWordPiece {
  std::unordered_map<std::string, int32_t> root;  // pieces without "##"
  std::unordered_map<std::string, int32_t> cont;  // "##" pieces, prefix stripped
};

void* ndp_wordpiece_build(const uint8_t* vocab_bytes, const int64_t* offsets,
                          int64_t n_tokens) {
  auto* h = new NdpWordPiece();
  for (int64_t i = 0; i < n_tokens; ++i) {
    const char* p = (const char*)vocab_bytes + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    if (len >= 2 && p[0] == '#' && p[1] == '#')
      h->cont.emplace(std::string(p + 2, (size_t)(len - 2)), (int32_t)i);
    else
      h->root.emplace(std::string(p, (size_t)len), (int32_t)i);
  }
  return h;
}

void ndp_wordpiece_free(void* handle) { delete (NdpWordPiece*)handle; }

// greedy longest-match of ONE word (bytes [wp, wp+wlen)) against the vocab;
// appends piece ids, or rolls back to a single unk_id when no full tiling
// exists (BERT whole-word [UNK]). Shared by the pre-normalized-words and
// the one-pass ASCII entry points.
static void wp_match_word(const NdpWordPiece* H, const char* wp, int64_t wlen,
                          int32_t unk_id, std::string& probe,
                          std::vector<int32_t>& pieces) {
  if (wlen == 0) return;  // Python yields no pieces for ""
  size_t mark = pieces.size();
  int64_t start = 0;
  while (start < wlen) {
    int64_t end = wlen;
    int32_t id = -1;
    for (; end > start; --end) {
      probe.assign(wp + start, (size_t)(end - start));
      const auto& m = start ? H->cont : H->root;
      auto it = m.find(probe);
      if (it != m.end()) { id = it->second; break; }
    }
    if (id < 0) {
      pieces.resize(mark);
      pieces.push_back(unk_id);
      return;
    }
    pieces.push_back(id);
    start = end;
  }
}

// finalize one output row: [CLS] pieces… [SEP], pad — piece list truncated
// to max_len-2 exactly like the Python `[:max_len-2]`
static void wp_emit_row(std::vector<int32_t>& pieces, int32_t cls_id,
                        int32_t sep_id, int32_t pad_id, int32_t max_len,
                        int32_t* ids, int32_t* mask) {
  // the Python layer rejects max_len < 2 before calling in; guard anyway —
  // a negative cap cast to size_t below would be a multi-exabyte resize
  // and the CLS/SEP stores would run off the (caller-zeroed) row
  if (max_len < 2) { pieces.clear(); return; }
  const int32_t cap = max_len - 2;
  if ((int32_t)pieces.size() > cap) pieces.resize((size_t)cap);
  int32_t pos = 0;
  ids[pos++] = cls_id;
  for (int32_t p : pieces) ids[pos++] = p;
  ids[pos++] = sep_id;
  for (int32_t j = pos; j < max_len; ++j) ids[j] = pad_id;
  for (int32_t j = 0; j < max_len; ++j) mask[j] = j < pos ? 1 : 0;
}

// words arrive pre-normalized as concatenated UTF-8 bytes + offsets
// (n_words+1), grouped per text by text_word_counts (n_texts). A word with
// no full vocab tiling emits ONE unk_id (BERT whole-word [UNK]; the Python
// side substitutes a lone 0xff byte for over-long words so the same rule
// fires). Rows: [CLS] pieces… [SEP], pad — piece list truncated to
// max_len-2 exactly like the Python `[:max_len-2]`.
void ndp_wordpiece_encode(void* handle, const uint8_t* word_bytes,
                          const int64_t* word_offsets,
                          const int64_t* text_word_counts, int64_t n_texts,
                          int32_t unk_id, int32_t cls_id, int32_t sep_id,
                          int32_t pad_id, int32_t max_len, int n_threads,
                          int32_t* ids_out, int32_t* mask_out) {
  auto* H = (NdpWordPiece*)handle;
  std::vector<int64_t> first(n_texts + 1, 0);
  for (int64_t i = 0; i < n_texts; ++i)
    first[i + 1] = first[i] + text_word_counts[i];
  int64_t total_bytes = first[n_texts] ? word_offsets[first[n_texts]] : 0;
  parallel_for(n_texts, effective_threads_compute(total_bytes, n_threads),
               [&](int64_t lo, int64_t hi) {
    std::string probe;          // reused across probes — no realloc once grown
    std::vector<int32_t> pieces;
    const int32_t cap = max_len - 2;
    for (int64_t t = lo; t < hi; ++t) {
      pieces.clear();
      for (int64_t w = first[t];
           w < first[t + 1] && (int32_t)pieces.size() < cap; ++w) {
        wp_match_word(H, (const char*)word_bytes + word_offsets[w],
                      word_offsets[w + 1] - word_offsets[w], unk_id, probe,
                      pieces);
      }
      wp_emit_row(pieces, cls_id, sep_id, pad_id, max_len,
                  ids_out + t * max_len, mask_out + t * max_len);
    }
  });
}

// One-pass normalize + match for ASCII text (the dominant cost is the
// normalization, not the matching — measured: the Python per-char
// clean/lower/punct-split loops are ~16x the match time). For pure-ASCII
// input the BERT basic tokenizer reduces to byte rules, derived exactly
// from data/wordpiece.py's Python implementation:
//   drop    0x00-0x08, 0x0b, 0x0c, 0x0e-0x1f, 0x7f   (control → removed)
//   space   0x09 0x0a 0x0d 0x20                      (whitespace → split)
//   punct   33-47, 58-64, 91-96, 123-126             (own single-char word)
//   letter  'A'-'Z' → +32 (lowercase); NFD strip is identity on ASCII
// Non-ASCII texts stay on the Python normalizer (the caller splits rows).
static inline bool wp_ascii_punct(uint8_t b) {
  return (b >= 33 && b <= 47) || (b >= 58 && b <= 64) || (b >= 91 && b <= 96) ||
         (b >= 123 && b <= 126);
}

void ndp_wordpiece_encode_ascii(void* handle, const uint8_t* bytes,
                                const int64_t* offsets, int64_t n_texts,
                                int32_t unk_id, int32_t cls_id, int32_t sep_id,
                                int32_t pad_id, int32_t max_len,
                                int32_t max_word_chars, int n_threads,
                                int32_t* ids_out, int32_t* mask_out) {
  auto* H = (NdpWordPiece*)handle;
  int64_t total = n_texts ? offsets[n_texts] : 0;
  parallel_for(n_texts, effective_threads_compute(total, n_threads),
               [&](int64_t lo, int64_t hi) {
    std::string probe;
    std::string word;           // current normalized word, reused
    std::vector<int32_t> pieces;
    const int32_t cap = max_len - 2;
    for (int64_t t = lo; t < hi; ++t) {
      pieces.clear();
      word.clear();
      const uint8_t* p = bytes + offsets[t];
      const uint8_t* end = bytes + offsets[t + 1];
      auto flush = [&] {
        if (!word.empty()) {
          if ((int32_t)word.size() > max_word_chars)
            pieces.push_back(unk_id);  // over-long word → whole-word [UNK]
          else
            wp_match_word(H, word.data(), (int64_t)word.size(), unk_id,
                          probe, pieces);
          word.clear();
        }
      };
      for (; p < end && (int32_t)pieces.size() < cap; ++p) {
        uint8_t b = *p;
        if (b == 0x09 || b == 0x0a || b == 0x0d || b == 0x20) {
          flush();
        } else if (b < 0x20 || b == 0x7f) {
          continue;  // control byte: removed (not a separator)
        } else if (wp_ascii_punct(b)) {
          flush();
          char c = (char)b;
          wp_match_word(H, &c, 1, unk_id, probe, pieces);
        } else {
          if (b >= 'A' && b <= 'Z') b += 32;
          word.push_back((char)b);
        }
      }
      if ((int32_t)pieces.size() < cap) flush();
      wp_emit_row(pieces, cls_id, sep_id, pad_id, max_len,
                  ids_out + t * max_len, mask_out + t * max_len);
    }
  });
}

}  // extern "C"

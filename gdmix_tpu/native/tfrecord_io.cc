// Native TFRecord + tf.train.Example batch decoder.
//
// The reference relies on TensorFlow's C++ tf.data kernels for record decode
// (SURVEY.md §2 native-surface list); this is the equivalent native component
// for this build's host-side input path: one pass over a TFRecord buffer,
// protobuf wire-format Example parsing (the narrow schema the framework uses:
// scalar int64/float dense columns + one sparse indices/values feature bag),
// filled straight into caller-provided numpy buffers via a ctypes C API.
//
// Wire format notes (mirrors gdmix_tpu/io/proto.py, verified against
// tf.train.Example in tests):
//   Example        = { 1: Features }
//   Features       = { 1: repeated MapEntry { 1: key, 2: Feature } }
//   Feature        = { 1: BytesList, 2: FloatList, 3: Int64List }
//   FloatList      = { 1: packed/unpacked float }
//   Int64List      = { 1: packed/unpacked varint }
// TFRecord framing = u64 len | u32 crc(len) | payload | u32 crc(payload).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tfrecord_io.cc -o libgdmix_io.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Chunked parallel-for: fn(lo, hi) over [0, n). Thread count from
// GDMIX_TPU_NATIVE_THREADS (default hardware_concurrency, cap 16).
template <typename Fn>
void parallel_for(int64_t n, int64_t grain, Fn&& fn) {
  int threads = 0;
  if (const char* env = std::getenv("GDMIX_TPU_NATIVE_THREADS"))
    threads = std::atoi(env);
  if (threads <= 0)
    threads = static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, 16));
  if (threads == 1 || n < grain * 2) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  threads = static_cast<int>(
      std::min<int64_t>(threads, (n + grain - 1) / grain));
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

struct Slice {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool empty() const { return p >= end; }

  uint64_t varint() {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return acc;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  Slice sub(uint64_t n) {
    // subtraction form: huge corrupt lengths must not overflow the pointer
    if (n > static_cast<uint64_t>(end - p)) {
      ok = false;
      return {end, end};
    }
    Slice s{p, p + n};
    p += n;
    return s;
  }

  void skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); break;
      case 1: p = (end - p >= 8) ? p + 8 : end + 1; break;
      case 2: {
        uint64_t n = varint();
        p = (n <= static_cast<uint64_t>(end - p)) ? p + n : end + 1;
        break;
      }
      case 5: p = (end - p >= 4) ? p + 4 : end + 1; break;
      default: ok = false;
    }
    if (p > end) { p = end; ok = false; }
  }
};

// One record's decoded feature values (only what the schema asks for).
struct Parsed {
  // dense scalar columns: first value of each requested feature. Int64 values
  // keep exact 64-bit fidelity in dense_i (doubles only carry 53 bits).
  std::vector<double> dense;     // [num_dense]
  std::vector<int64_t> dense_i;  // [num_dense]
  std::vector<uint8_t> present;  // [num_dense]
  std::vector<int64_t> bag_idx;
  std::vector<double> bag_val;
};

struct Handle {
  std::vector<std::string> dense_names;
  std::string idx_name, val_name;
  std::vector<Parsed> records;
  int32_t max_nnz = 0;
  std::string error;
};

// Parse a Feature message, appending numeric values to out (and exact int64
// copies to iout when the wire type was Int64List).
void parse_feature_values(Slice s, std::vector<double>* out,
                          std::vector<int64_t>* iout = nullptr) {
  while (!s.empty() && s.ok) {
    uint64_t tag = s.varint();
    uint32_t field = tag >> 3, wire = tag & 7;
    if (wire != 2) { s.skip(wire); continue; }
    Slice inner = s.sub(s.varint());
    if (field == 2) {  // FloatList
      while (!inner.empty() && inner.ok) {
        uint64_t t2 = inner.varint();
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {  // packed
          Slice packed = inner.sub(inner.varint());
          while (packed.p + 4 <= packed.end) {
            float f;
            std::memcpy(&f, packed.p, 4);
            packed.p += 4;
            out->push_back(static_cast<double>(f));
          }
        } else if ((t2 >> 3) == 1 && (t2 & 7) == 5) {
          float f;
          if (inner.p + 4 <= inner.end) {
            std::memcpy(&f, inner.p, 4);
            inner.p += 4;
            out->push_back(static_cast<double>(f));
          } else {
            inner.ok = false;
          }
        } else {
          inner.skip(t2 & 7);
        }
      }
    } else if (field == 3) {  // Int64List
      while (!inner.empty() && inner.ok) {
        uint64_t t2 = inner.varint();
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {  // packed
          Slice packed = inner.sub(inner.varint());
          while (!packed.empty() && packed.ok) {
            int64_t v = static_cast<int64_t>(packed.varint());
            out->push_back(static_cast<double>(v));
            if (iout) iout->push_back(v);
          }
        } else if ((t2 >> 3) == 1 && (t2 & 7) == 0) {
          int64_t v = static_cast<int64_t>(inner.varint());
          out->push_back(static_cast<double>(v));
          if (iout) iout->push_back(v);
        } else {
          inner.skip(t2 & 7);
        }
      }
    }
    // BytesList (field 1) ignored: string columns use the python path.
  }
}

void parse_example(Slice payload, Handle* h, Parsed* rec) {
  const size_t nd = h->dense_names.size();
  rec->dense.assign(nd, 0.0);
  rec->dense_i.assign(nd, 0);
  rec->present.assign(nd, 0);
  while (!payload.empty() && payload.ok) {
    uint64_t tag = payload.varint();
    if (tag != ((1 << 3) | 2)) { payload.skip(tag & 7); continue; }
    Slice features = payload.sub(payload.varint());
    while (!features.empty() && features.ok) {
      uint64_t ftag = features.varint();
      if (ftag != ((1 << 3) | 2)) { features.skip(ftag & 7); continue; }
      Slice entry = features.sub(features.varint());
      std::string key;
      Slice feature{nullptr, nullptr};
      while (!entry.empty() && entry.ok) {
        uint64_t etag = entry.varint();
        uint32_t fieldno = etag >> 3, wire = etag & 7;
        if (wire != 2) { entry.skip(wire); continue; }
        Slice v = entry.sub(entry.varint());
        if (fieldno == 1) {
          key.assign(reinterpret_cast<const char*>(v.p), v.end - v.p);
        } else if (fieldno == 2) {
          feature = v;
        }
      }
      if (feature.p == nullptr) continue;
      if (key == h->idx_name) {
        std::vector<double> vals;
        parse_feature_values(feature, &vals);
        rec->bag_idx.reserve(vals.size());
        for (double d : vals) rec->bag_idx.push_back(static_cast<int64_t>(d));
      } else if (key == h->val_name) {
        parse_feature_values(feature, &rec->bag_val);
      } else {
        for (size_t i = 0; i < nd; ++i) {
          if (key == h->dense_names[i]) {
            std::vector<double> vals;
            std::vector<int64_t> ivals;
            parse_feature_values(feature, &vals, &ivals);
            if (!vals.empty()) {
              rec->dense[i] = vals[0];
              rec->dense_i[i] = ivals.empty()
                  ? static_cast<int64_t>(vals[0]) : ivals[0];
              rec->present[i] = 1;
            }
            break;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Parse an in-memory TFRecord buffer. Returns a handle (or nullptr on error).
void* gdx_parse(const uint8_t* data, int64_t len, const char** dense_names,
                int32_t num_dense, const char* idx_name, const char* val_name) {
  auto* h = new Handle();
  for (int32_t i = 0; i < num_dense; ++i) h->dense_names.emplace_back(dense_names[i]);
  h->idx_name = idx_name ? idx_name : "";
  h->val_name = val_name ? val_name : "";

  const uint8_t* p = data;
  const uint8_t* end = data + len;
  std::vector<Slice> payloads;
  while (p < end) {
    if (p + 12 > end) { delete h; return nullptr; }
    uint64_t rec_len;
    std::memcpy(&rec_len, p, 8);
    p += 12;  // len + len-crc
    if (rec_len > static_cast<uint64_t>(end - p) ||
        end - p - rec_len < 4) { delete h; return nullptr; }
    payloads.push_back(Slice{p, p + rec_len});
    p += rec_len + 4;  // payload + payload-crc
  }
  h->records.resize(payloads.size());
  std::vector<int32_t> nnz(std::max<size_t>(payloads.size(), 1), 0);
  parallel_for(static_cast<int64_t>(payloads.size()), 4096,
               [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      parse_example(payloads[r], h, &h->records[r]);
      nnz[r] = static_cast<int32_t>(h->records[r].bag_idx.size());
    }
  });
  for (size_t r = 0; r < payloads.size(); ++r)
    h->max_nnz = std::max(h->max_nnz, nnz[r]);
  return h;
}

int64_t gdx_num_records(void* handle) {
  return static_cast<Handle*>(handle)->records.size();
}

int32_t gdx_max_nnz(void* handle) {
  return static_cast<Handle*>(handle)->max_nnz;
}

// Fill a dense column: out[N] doubles, present[N] flags (0 → absent).
void gdx_fill_dense(void* handle, int32_t col, double* out, uint8_t* present) {
  auto* h = static_cast<Handle*>(handle);
  for (size_t i = 0; i < h->records.size(); ++i) {
    out[i] = h->records[i].dense[col];
    present[i] = h->records[i].present[col];
  }
}

// Fill a dense column with exact int64 values.
void gdx_fill_dense_i64(void* handle, int32_t col, int64_t* out,
                        uint8_t* present) {
  auto* h = static_cast<Handle*>(handle);
  for (size_t i = 0; i < h->records.size(); ++i) {
    out[i] = h->records[i].dense_i[col];
    present[i] = h->records[i].present[col];
  }
}

// Fill the sparse bag: idx_out/val_out are [N, K] row-major (zero-prefilled by
// the caller), nnz_out is [N].
void gdx_fill_sparse(void* handle, int32_t K, int64_t* idx_out, double* val_out,
                     int32_t* nnz_out) {
  auto* h = static_cast<Handle*>(handle);
  for (size_t i = 0; i < h->records.size(); ++i) {
    const Parsed& r = h->records[i];
    int32_t n = static_cast<int32_t>(r.bag_idx.size());
    if (n > K) n = K;
    nnz_out[i] = n;
    for (int32_t j = 0; j < n; ++j) {
      idx_out[i * K + j] = r.bag_idx[j];
      val_out[i * K + j] = j < static_cast<int32_t>(r.bag_val.size())
                               ? r.bag_val[j] : 0.0;
    }
  }
}

void gdx_free(void* handle) { delete static_cast<Handle*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// SequenceExample (grouped per-entity) decoder.
//
// The reference decodes grouped datasets with TF's C++ parse_sequence_example
// kernel (input_data_pipeline.py:223-332); this is this build's native
// equivalent for the random-effect input path. One record = one entity:
//   SequenceExample = { 1: context (Features), 2: feature_lists }
//   FeatureLists    = { 1: repeated MapEntry { 1: key, 2: FeatureList } }
//   FeatureList     = { 1: repeated Feature }
// Context carries the scalar entity id + VarLen per-record columns; the
// sequence carries the ragged sparse feature bag. Output is COLUMNAR: flat
// per-record arrays for the whole buffer plus per-entity record counts, so
// Python builds entity views with zero per-record work.
// ---------------------------------------------------------------------------

namespace {

struct SeqParsed {
  std::string entity;
  std::vector<std::vector<double>> ctx;     // [num_ctx][n_records]
  std::vector<std::vector<int64_t>> ctx_i;  // exact int64 copies
  std::vector<uint8_t> ctx_present;         // [num_ctx]
  std::vector<std::vector<int64_t>> step_idx;  // [n_records][nnz]
  std::vector<std::vector<double>> step_val;
  int32_t n_records = 0;
  int32_t max_nnz = 0;      // per-record reductions (merged after the
  bool unknown = false;     // parallel parse pass)
  bool failed = false;
};

struct SeqHandle {
  std::vector<std::string> ctx_names;
  std::string entity_name, idx_name, val_name;
  std::vector<SeqParsed> entities;
  int64_t total_records = 0;
  int64_t total_id_bytes = 0;
  int32_t max_nnz = 0;
  bool unknown_context = false;  // context key outside the requested schema
};

// First bytes value of a Feature's BytesList (entity ids); empty if none.
std::string parse_feature_first_bytes(Slice s, bool* found) {
  *found = false;
  while (!s.empty() && s.ok) {
    uint64_t tag = s.varint();
    if ((tag >> 3) == 1 && (tag & 7) == 2) {  // BytesList
      Slice inner = s.sub(s.varint());
      while (!inner.empty() && inner.ok) {
        uint64_t t2 = inner.varint();
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          Slice v = inner.sub(inner.varint());
          *found = true;
          return std::string(reinterpret_cast<const char*>(v.p), v.end - v.p);
        }
        inner.skip(t2 & 7);
      }
    } else {
      s.skip(tag & 7);
    }
  }
  return "";
}

// Parse the Features message of a context block into rec.
void parse_seq_context(Slice features, SeqHandle* h, SeqParsed* rec) {
  const size_t nc = h->ctx_names.size();
  rec->ctx.assign(nc, {});
  rec->ctx_i.assign(nc, {});
  rec->ctx_present.assign(nc, 0);
  while (!features.empty() && features.ok) {
    uint64_t ftag = features.varint();
    if (ftag != ((1 << 3) | 2)) { features.skip(ftag & 7); continue; }
    Slice entry = features.sub(features.varint());
    std::string key;
    Slice feature{nullptr, nullptr};
    while (!entry.empty() && entry.ok) {
      uint64_t etag = entry.varint();
      uint32_t fieldno = etag >> 3, wire = etag & 7;
      if (wire != 2) { entry.skip(wire); continue; }
      Slice v = entry.sub(entry.varint());
      if (fieldno == 1) {
        key.assign(reinterpret_cast<const char*>(v.p), v.end - v.p);
      } else if (fieldno == 2) {
        feature = v;
      }
    }
    if (feature.p == nullptr) continue;
    if (key == h->entity_name) {
      bool found = false;
      std::string id = parse_feature_first_bytes(feature, &found);
      if (found) {
        rec->entity = std::move(id);
      } else {  // Int64List entity id → decimal string (≡ python str())
        std::vector<double> vals;
        std::vector<int64_t> ivals;
        parse_feature_values(feature, &vals, &ivals);
        if (!ivals.empty()) rec->entity = std::to_string(ivals[0]);
        else if (!vals.empty())
          rec->entity = std::to_string(static_cast<int64_t>(vals[0]));
      }
      continue;
    }
    bool known = false;
    for (size_t i = 0; i < nc; ++i) {
      if (key == h->ctx_names[i]) {
        parse_feature_values(feature, &rec->ctx[i], &rec->ctx_i[i]);
        if (rec->ctx_i[i].empty())
          rec->ctx_i[i].assign(rec->ctx[i].size(), 0);
        rec->ctx_present[i] = 1;
        known = true;
        break;
      }
    }
    if (!known) rec->unknown = true;
  }
}

// Parse the FeatureLists message, keeping only the idx/val lists.
void parse_seq_lists(Slice lists, SeqHandle* h, SeqParsed* rec) {
  while (!lists.empty() && lists.ok) {
    uint64_t tag = lists.varint();
    if (tag != ((1 << 3) | 2)) { lists.skip(tag & 7); continue; }
    Slice entry = lists.sub(lists.varint());
    std::string key;
    Slice flist{nullptr, nullptr};
    while (!entry.empty() && entry.ok) {
      uint64_t etag = entry.varint();
      uint32_t fieldno = etag >> 3, wire = etag & 7;
      if (wire != 2) { entry.skip(wire); continue; }
      Slice v = entry.sub(entry.varint());
      if (fieldno == 1) {
        key.assign(reinterpret_cast<const char*>(v.p), v.end - v.p);
      } else if (fieldno == 2) {
        flist = v;  // whole FeatureList slice (repeated field 1 = Feature)
      }
    }
    bool want_idx = (key == h->idx_name), want_val = (key == h->val_name);
    if (flist.p == nullptr || (!want_idx && !want_val)) continue;
    while (!flist.empty() && flist.ok) {
      uint64_t t = flist.varint();
      if (t != ((1 << 3) | 2)) { flist.skip(t & 7); continue; }
      Slice feature = flist.sub(flist.varint());
      std::vector<double> vals;
      std::vector<int64_t> ivals;
      parse_feature_values(feature, &vals, &ivals);
      if (want_idx) {
        if (!ivals.empty() || vals.empty()) {
          rec->max_nnz = std::max<int32_t>(rec->max_nnz, ivals.size());
          rec->step_idx.push_back(std::move(ivals));
        } else {
          std::vector<int64_t> conv(vals.size());
          for (size_t i = 0; i < vals.size(); ++i)
            conv[i] = static_cast<int64_t>(vals[i]);
          rec->max_nnz = std::max<int32_t>(rec->max_nnz, conv.size());
          rec->step_idx.push_back(std::move(conv));
        }
      } else {
        rec->max_nnz = std::max<int32_t>(rec->max_nnz, vals.size());
        rec->step_val.push_back(std::move(vals));
      }
    }
  }
}

}  // namespace

extern "C" {

// Parse an in-memory TFRecord buffer of SequenceExamples (one per entity).
void* gdx_seq_parse(const uint8_t* data, int64_t len, const char** ctx_names,
                    int32_t num_ctx, const char* entity_name,
                    const char* idx_name, const char* val_name) {
  auto* h = new SeqHandle();
  for (int32_t i = 0; i < num_ctx; ++i) h->ctx_names.emplace_back(ctx_names[i]);
  h->entity_name = entity_name ? entity_name : "";
  h->idx_name = idx_name ? idx_name : "";
  h->val_name = val_name ? val_name : "";

  // framing scan (sequential, just length fields), then parallel parse
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  std::vector<Slice> payloads;
  while (p < end) {
    if (p + 12 > end) { delete h; return nullptr; }
    uint64_t rec_len;
    std::memcpy(&rec_len, p, 8);
    p += 12;
    if (rec_len > static_cast<uint64_t>(end - p) ||
        end - p - rec_len < 4) { delete h; return nullptr; }
    payloads.push_back(Slice{p, p + rec_len});
    p += rec_len + 4;
  }
  h->entities.resize(payloads.size());
  parallel_for(static_cast<int64_t>(payloads.size()), 512,
               [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      Slice payload = payloads[r];
      SeqParsed* rec = &h->entities[r];
      // a corrupt record may carry no context field at all; the fills index
      // rec->ctx[col] unconditionally, so the shape must hold regardless
      rec->ctx.assign(h->ctx_names.size(), {});
      rec->ctx_i.assign(h->ctx_names.size(), {});
      rec->ctx_present.assign(h->ctx_names.size(), 0);
      while (!payload.empty() && payload.ok) {
        uint64_t tag = payload.varint();
        uint32_t fieldno = tag >> 3, wire = tag & 7;
        if (wire != 2) { payload.skip(wire); continue; }
        Slice v = payload.sub(payload.varint());
        if (fieldno == 1) parse_seq_context(v, h, rec);
        else if (fieldno == 2) parse_seq_lists(v, h, rec);
      }
      if (!payload.ok) { rec->failed = true; continue; }
      size_t n = std::max(rec->step_idx.size(), rec->step_val.size());
      for (size_t i = 0; i < rec->ctx.size(); ++i)
        n = std::max(n, rec->ctx[i].size());
      rec->n_records = static_cast<int32_t>(n);
    }
  });
  for (const SeqParsed& rec : h->entities) {
    if (rec.failed) { delete h; return nullptr; }
    if (rec.unknown) h->unknown_context = true;
    h->max_nnz = std::max(h->max_nnz, rec.max_nnz);
    h->total_records += rec.n_records;
    h->total_id_bytes += static_cast<int64_t>(rec.entity.size());
  }
  return h;
}

int64_t gdx_seq_num_entities(void* handle) {
  return static_cast<SeqHandle*>(handle)->entities.size();
}

int64_t gdx_seq_total_records(void* handle) {
  return static_cast<SeqHandle*>(handle)->total_records;
}

int64_t gdx_seq_id_bytes(void* handle) {
  return static_cast<SeqHandle*>(handle)->total_id_bytes;
}

int32_t gdx_seq_max_nnz(void* handle) {
  return static_cast<SeqHandle*>(handle)->max_nnz;
}

int32_t gdx_seq_has_unknown_context(void* handle) {
  return static_cast<SeqHandle*>(handle)->unknown_context ? 1 : 0;
}

// Per-entity record counts [E] and concatenated utf-8 entity ids
// (offsets [E+1] into buf).
void gdx_seq_fill_meta(void* handle, int32_t* counts, char* id_buf,
                       int64_t* id_offsets) {
  auto* h = static_cast<SeqHandle*>(handle);
  int64_t off = 0;
  for (size_t e = 0; e < h->entities.size(); ++e) {
    counts[e] = h->entities[e].n_records;
    id_offsets[e] = off;
    const std::string& id = h->entities[e].entity;
    std::memcpy(id_buf + off, id.data(), id.size());
    off += id.size();
  }
  id_offsets[h->entities.size()] = off;
}

// Flat context column col: out[total_records] f64, present[E] flags. Entities
// missing the column (or with short lists) contribute zeros.
void gdx_seq_fill_ctx(void* handle, int32_t col, double* out,
                      uint8_t* present) {
  auto* h = static_cast<SeqHandle*>(handle);
  int64_t r = 0;
  for (size_t e = 0; e < h->entities.size(); ++e) {
    const SeqParsed& rec = h->entities[e];
    present[e] = rec.ctx_present[col];
    const auto& v = rec.ctx[col];
    for (int32_t i = 0; i < rec.n_records; ++i)
      out[r + i] = i < static_cast<int32_t>(v.size()) ? v[i] : 0.0;
    r += rec.n_records;
  }
}

void gdx_seq_fill_ctx_i64(void* handle, int32_t col, int64_t* out,
                          uint8_t* present) {
  auto* h = static_cast<SeqHandle*>(handle);
  int64_t r = 0;
  for (size_t e = 0; e < h->entities.size(); ++e) {
    const SeqParsed& rec = h->entities[e];
    present[e] = rec.ctx_present[col];
    const auto& v = rec.ctx_i[col];
    for (int32_t i = 0; i < rec.n_records; ++i)
      out[r + i] = i < static_cast<int32_t>(v.size()) ? v[i] : 0;
    r += rec.n_records;
  }
}

// Flat padded sparse bag: idx/val are [total_records, K] row-major
// (zero-prefilled by the caller), nnz [total_records].
void gdx_seq_fill_sparse(void* handle, int32_t K, int64_t* idx_out,
                         double* val_out, int32_t* nnz_out) {
  auto* h = static_cast<SeqHandle*>(handle);
  int64_t r = 0;
  for (size_t e = 0; e < h->entities.size(); ++e) {
    const SeqParsed& rec = h->entities[e];
    for (int32_t i = 0; i < rec.n_records; ++i) {
      const std::vector<int64_t>* idx =
          i < static_cast<int32_t>(rec.step_idx.size()) ? &rec.step_idx[i]
                                                        : nullptr;
      const std::vector<double>* val =
          i < static_cast<int32_t>(rec.step_val.size()) ? &rec.step_val[i]
                                                        : nullptr;
      int32_t n = idx ? static_cast<int32_t>(idx->size()) : 0;
      if (n > K) n = K;
      nnz_out[r + i] = n;
      for (int32_t j = 0; j < n; ++j) {
        idx_out[(r + i) * K + j] = (*idx)[j];
        val_out[(r + i) * K + j] =
            val && j < static_cast<int32_t>(val->size()) ? (*val)[j] : 0.0;
      }
    }
    r += rec.n_records;
  }
}

void gdx_seq_free(void* handle) { delete static_cast<SeqHandle*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native TFRecord ENCODERS (Example per-record + grouped SequenceExample).
// The DataPartitioner's output and the OffsetUpdater's dataset re-emission
// are write-bound in the per-record python encoder (~4k entities/s); these
// emit byte-identical framed records (incl. masked crc32c) from columnar
// inputs in one pass. Mirrors gdmix_tpu/io/proto.py + tfrecord.py exactly.
// ---------------------------------------------------------------------------

namespace {

struct Crc32c {
  uint32_t table[256];
  Crc32c() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
  uint32_t run(const uint8_t* p, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i)
      c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }
  uint32_t masked(const uint8_t* p, size_t n) const {
    uint32_t c = run(p, n);
    return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
  }
};

const Crc32c kCrc;

struct Writer {
  uint8_t* p;
  uint8_t* end;
  bool ok = true;

  void varint(uint64_t v) {
    while (v >= 0x80) {
      if (p >= end) { ok = false; return; }
      *p++ = static_cast<uint8_t>(v) | 0x80;
      v >>= 7;
    }
    if (p >= end) { ok = false; return; }
    *p++ = static_cast<uint8_t>(v);
  }
  void raw(const void* src, size_t n) {
    if (static_cast<size_t>(end - p) < n) { ok = false; return; }
    std::memcpy(p, src, n);
    p += n;
  }
  void byte(uint8_t b) {
    if (p >= end) { ok = false; return; }
    *p++ = b;
  }
};

inline int varint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

// Feature message bytes for a float column slice (FloatList, packed f32).
inline void put_float_feature(Writer& w, const double* vals, int64_t n) {
  const int64_t packed = 4 * n;
  const int64_t field1 = 1 + varint_size(packed) + packed;  // inner FloatList
  if (n) {
    w.byte(0x12);                    // Feature.float_list (field 2, LEN)
    w.varint(field1);
    w.byte(0x0A);                    // FloatList.value (field 1, LEN packed)
    w.varint(packed);
    for (int64_t i = 0; i < n; ++i) {
      float f = static_cast<float>(vals[i]);
      w.raw(&f, 4);
    }
  }
}

inline void put_int_feature(Writer& w, const int64_t* vals, int64_t n) {
  if (!n) return;
  int64_t body = 0;
  for (int64_t i = 0; i < n; ++i)
    body += varint_size(static_cast<uint64_t>(vals[i]));
  w.byte(0x1A);                      // Feature.int64_list (field 3, LEN)
  w.varint(1 + varint_size(body) + body);
  w.byte(0x0A);                      // Int64List.value (field 1, LEN packed)
  w.varint(body);
  for (int64_t i = 0; i < n; ++i)
    w.varint(static_cast<uint64_t>(vals[i]));
}

inline void put_bytes_feature(Writer& w, const uint8_t* b, int64_t n) {
  const int64_t inner = 1 + varint_size(n) + n;  // repeated field1 (one elem)
  w.byte(0x0A);                      // Feature.bytes_list (field 1, LEN)
  w.varint(inner);
  w.byte(0x0A);                      // BytesList.value
  w.varint(n);
  w.raw(b, n);
}

inline int64_t float_feature_size(int64_t n) {
  if (!n) return 0;
  int64_t packed = 4 * n;
  int64_t f1 = 1 + varint_size(packed) + packed;
  return 1 + varint_size(f1) + f1;
}

inline int64_t int_feature_size(const int64_t* vals, int64_t n) {
  if (!n) return 0;
  int64_t body = 0;
  for (int64_t i = 0; i < n; ++i)
    body += varint_size(static_cast<uint64_t>(vals[i]));
  int64_t f1 = 1 + varint_size(body) + body;
  return 1 + varint_size(f1) + f1;
}

// map entry "features { key, Feature }": field1 key, field2 feature-bytes
inline int64_t map_entry_size(int64_t key_len, int64_t feat_len) {
  int64_t entry = 1 + varint_size(key_len) + key_len
                + 1 + varint_size(feat_len) + feat_len;
  return 1 + varint_size(entry) + entry;
}

inline void put_map_entry_header(Writer& w, const char* key, int64_t key_len,
                                 int64_t feat_len) {
  int64_t entry = 1 + varint_size(key_len) + key_len
                + 1 + varint_size(feat_len) + feat_len;
  w.byte(0x0A);                      // Features.feature map entry
  w.varint(entry);
  w.byte(0x0A);                      // key
  w.varint(key_len);
  w.raw(key, key_len);
  w.byte(0x12);                      // value (Feature)
  w.varint(feat_len);
}

struct SeqSpec {
  const int64_t* ids_i;
  const uint8_t* ids_b;
  const int64_t* ids_off;
  const char* entity_name;
  int64_t ename_len;
  const int64_t* counts;
  const int64_t* rec_start;  // [E] record offsets (prefix sum of counts)
  const char** col_names;
  const char* col_types;
  int32_t ncols;
  const double** fcols;
  const int64_t** icols;
  const char* idx_name;
  int64_t iname_len;
  const char* val_name;
  int64_t vname_len;
  const int64_t* sp_idx;
  const double* sp_val;
  const int32_t* rec_nnz;
  int32_t K;
};

int64_t seq_id_feat_len(const SeqSpec& s, int64_t e) {
  if (s.ids_i) return int_feature_size(&s.ids_i[e], 1);
  int64_t bl = s.ids_off[e + 1] - s.ids_off[e];
  int64_t inner = 1 + varint_size(bl) + bl;
  return 1 + varint_size(inner) + inner;
}

int64_t seq_ctx_len(const SeqSpec& s, int64_t e) {
  const int64_t n = s.counts[e];
  const int64_t start = s.rec_start[e];
  int64_t ctx = map_entry_size(s.ename_len, seq_id_feat_len(s, e));
  for (int32_t c = 0; c < s.ncols; ++c) {
    int64_t fl = s.col_types[c] == 'f'
        ? float_feature_size(n)
        : int_feature_size(s.icols[c] + start, n);
    ctx += map_entry_size(std::strlen(s.col_names[c]), fl);
  }
  return ctx;
}

int64_t seq_featlist_len(const SeqSpec& s, int64_t e, int pass) {
  const int64_t n = s.counts[e];
  const int64_t start = s.rec_start[e];
  int64_t fl_len = 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t m = s.rec_nnz[start + r];
    int64_t feat = pass == 0
        ? int_feature_size(s.sp_idx + (start + r) * s.K, m)
        : float_feature_size(m);
    fl_len += 1 + varint_size(feat) + feat;
  }
  return fl_len;
}

int64_t seq_lists_len(const SeqSpec& s, int64_t e) {
  if (s.K <= 0) return 0;
  int64_t lists = 0;
  for (int pass = 0; pass < 2; ++pass) {
    int64_t fl_len = seq_featlist_len(s, e, pass);
    int64_t nm = pass == 0 ? s.iname_len : s.vname_len;
    int64_t entry = 1 + varint_size(nm) + nm
                  + 1 + varint_size(fl_len) + fl_len;
    lists += 1 + varint_size(entry) + entry;
  }
  return lists;
}

// One framed record at dst (framing + payload + crcs); dst must hold
// 16 + body bytes. Returns false on a sizing bug.
bool seq_emit(const SeqSpec& s, int64_t e, int64_t ctx_len, int64_t lists_len,
              int64_t body, uint8_t* dst) {
  const int64_t n = s.counts[e];
  const int64_t start = s.rec_start[e];
  uint8_t* payload = dst + 12;
  Writer pw{payload, payload + body};
  pw.byte(0x0A);                   // SequenceExample.context
  pw.varint(ctx_len);
  put_map_entry_header(pw, s.entity_name, s.ename_len, seq_id_feat_len(s, e));
  if (s.ids_i) {
    put_int_feature(pw, &s.ids_i[e], 1);
  } else {
    put_bytes_feature(pw, s.ids_b + s.ids_off[e],
                      s.ids_off[e + 1] - s.ids_off[e]);
  }
  for (int32_t c = 0; c < s.ncols; ++c) {
    int64_t fl = s.col_types[c] == 'f'
        ? float_feature_size(n)
        : int_feature_size(s.icols[c] + start, n);
    put_map_entry_header(pw, s.col_names[c], std::strlen(s.col_names[c]), fl);
    if (s.col_types[c] == 'f')
      put_float_feature(pw, s.fcols[c] + start, n);
    else
      put_int_feature(pw, s.icols[c] + start, n);
  }
  pw.byte(0x12);                   // SequenceExample.feature_lists (always)
  pw.varint(lists_len);
  for (int pass = 0; pass < 2 && s.K > 0; ++pass) {
    int64_t fl_len = seq_featlist_len(s, e, pass);
    const char* nm = pass == 0 ? s.idx_name : s.val_name;
    int64_t nm_len = pass == 0 ? s.iname_len : s.vname_len;
    int64_t entry = 1 + varint_size(nm_len) + nm_len
                  + 1 + varint_size(fl_len) + fl_len;
    pw.byte(0x0A);                 // FeatureLists.feature_list map entry
    pw.varint(entry);
    pw.byte(0x0A);
    pw.varint(nm_len);
    pw.raw(nm, nm_len);
    pw.byte(0x12);                 // FeatureList
    pw.varint(fl_len);
    for (int64_t r = 0; r < n; ++r) {
      int64_t m = s.rec_nnz[start + r];
      int64_t feat = pass == 0
          ? int_feature_size(s.sp_idx + (start + r) * s.K, m)
          : float_feature_size(m);
      pw.byte(0x0A);               // FeatureList.feature
      pw.varint(feat);
      if (pass == 0)
        put_int_feature(pw, s.sp_idx + (start + r) * s.K, m);
      else
        put_float_feature(pw, s.sp_val + (start + r) * s.K, m);
    }
  }
  if (!pw.ok || pw.p != payload + body) return false;
  uint64_t len = static_cast<uint64_t>(body);
  std::memcpy(dst, &len, 8);
  uint32_t c = kCrc.masked(dst, 8);
  std::memcpy(dst + 8, &c, 4);
  c = kCrc.masked(payload, body);
  std::memcpy(dst + 12 + body, &c, 4);
  return true;
}

}  // namespace

extern "C" {

// Grouped SequenceExample writer. Entity ids as int64 (ids_i) OR utf-8
// blocks (ids_b + ids_off, E+1). Context columns are flat [N] entity-major
// (counts [E] delimit); col_types[i]: 'f' float, 'i' int64. Sparse bag:
// padded [N, K] + rec_nnz (pass K=0 for no bag). Output: framed TFRecords,
// records encoded in parallel at exact offsets (size pass + emit pass).
// Returns bytes written or -1 on overflow.
int64_t gdx_seq_write(const int64_t* ids_i, const uint8_t* ids_b,
                      const int64_t* ids_off, const char* entity_name,
                      const int64_t* counts, int64_t E,
                      const char** col_names, const char* col_types,
                      int32_t ncols, const double** fcols,
                      const int64_t** icols, const char* idx_name,
                      const char* val_name, const int64_t* sp_idx,
                      const double* sp_val, const int32_t* rec_nnz, int32_t K,
                      uint8_t* out, int64_t cap) {
  SeqSpec s{ids_i, ids_b, ids_off, entity_name,
            static_cast<int64_t>(std::strlen(entity_name)), counts, nullptr,
            col_names, col_types, ncols, fcols, icols, idx_name,
            idx_name ? static_cast<int64_t>(std::strlen(idx_name)) : 0,
            val_name,
            val_name ? static_cast<int64_t>(std::strlen(val_name)) : 0,
            sp_idx, sp_val, rec_nnz, K};
  std::vector<int64_t> rec_start(E);
  {
    int64_t acc = 0;
    for (int64_t e = 0; e < E; ++e) {
      rec_start[e] = acc;
      acc += counts[e];
    }
  }
  s.rec_start = rec_start.data();
  // pass 1 (parallel): per-entity sizes
  std::vector<int64_t> ctx(E), lists(E), body(E);
  parallel_for(E, 1024, [&](int64_t lo, int64_t hi) {
    for (int64_t e = lo; e < hi; ++e) {
      ctx[e] = seq_ctx_len(s, e);
      lists[e] = seq_lists_len(s, e);
      // the python encoder always writes feature_lists, even when empty
      body[e] = 1 + varint_size(ctx[e]) + ctx[e]
              + 1 + varint_size(lists[e]) + lists[e];
    }
  });
  std::vector<int64_t> off(E + 1);
  for (int64_t e = 0; e < E; ++e) off[e + 1] = off[e] + 16 + body[e];
  if (off[E] > cap) return -1;
  // pass 2 (parallel): emit each framed record at its exact offset
  std::vector<uint8_t> failed(std::max<int64_t>(E, 1), 0);
  parallel_for(E, 1024, [&](int64_t lo, int64_t hi) {
    for (int64_t e = lo; e < hi; ++e) {
      if (!seq_emit(s, e, ctx[e], lists[e], body[e], out + off[e]))
        failed[e] = 1;
    }
  });
  for (int64_t e = 0; e < E; ++e)
    if (failed[e]) return -1;
  return off[E];
}

// Per-record Example writer: one Example per row; columns flat [N];
// bag rows from padded [N, K] + rec_nnz. Returns bytes written or -1.
int64_t gdx_rec_write(const int64_t* dummy_unused, const char** col_names,
                      const char* col_types, int32_t ncols,
                      const double** fcols, const int64_t** icols,
                      const char* idx_name, const char* val_name,
                      const int64_t* sp_idx, const double* sp_val,
                      const int32_t* rec_nnz, int32_t K, int64_t N,
                      uint8_t* out, int64_t cap) {
  (void)dummy_unused;
  const int64_t iname_len = idx_name ? std::strlen(idx_name) : 0;
  const int64_t vname_len = val_name ? std::strlen(val_name) : 0;

  auto feats_len_of = [&](int64_t r) {
    int64_t feats_len = 0;
    for (int32_t c = 0; c < ncols; ++c) {
      int64_t fl = col_types[c] == 'f'
          ? float_feature_size(1)
          : int_feature_size(icols[c] + r, 1);
      feats_len += map_entry_size(std::strlen(col_names[c]), fl);
    }
    if (K > 0) {
      int64_t m = rec_nnz[r];
      feats_len += map_entry_size(iname_len,
                                  int_feature_size(sp_idx + r * K, m));
      feats_len += map_entry_size(vname_len, float_feature_size(m));
    }
    return feats_len;
  };

  std::vector<int64_t> feats(N), body(N);
  parallel_for(N, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      feats[r] = feats_len_of(r);
      body[r] = 1 + varint_size(feats[r]) + feats[r];
    }
  });
  std::vector<int64_t> off(N + 1);
  for (int64_t r = 0; r < N; ++r) off[r + 1] = off[r] + 16 + body[r];
  if (off[N] > cap) return -1;

  std::vector<uint8_t> failed(std::max<int64_t>(N, 1), 0);
  parallel_for(N, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      uint8_t* dst = out + off[r];
      uint8_t* payload = dst + 12;
      Writer pw{payload, payload + body[r]};
      pw.byte(0x0A);                 // Example.features
      pw.varint(feats[r]);
      for (int32_t c = 0; c < ncols; ++c) {
        int64_t fl = col_types[c] == 'f'
            ? float_feature_size(1)
            : int_feature_size(icols[c] + r, 1);
        put_map_entry_header(pw, col_names[c], std::strlen(col_names[c]), fl);
        if (col_types[c] == 'f')
          put_float_feature(pw, fcols[c] + r, 1);
        else
          put_int_feature(pw, icols[c] + r, 1);
      }
      if (K > 0) {
        int64_t m = rec_nnz[r];
        put_map_entry_header(pw, idx_name, iname_len,
                             int_feature_size(sp_idx + r * K, m));
        put_int_feature(pw, sp_idx + r * K, m);
        put_map_entry_header(pw, val_name, vname_len, float_feature_size(m));
        put_float_feature(pw, sp_val + r * K, m);
      }
      if (!pw.ok || pw.p != payload + body[r]) {
        failed[r] = 1;
        continue;
      }
      uint64_t len = static_cast<uint64_t>(body[r]);
      std::memcpy(dst, &len, 8);
      uint32_t crc = kCrc.masked(dst, 8);
      std::memcpy(dst + 8, &crc, 4);
      crc = kCrc.masked(payload, body[r]);
      std::memcpy(dst + 12 + body[r], &crc, 4);
    }
  });
  for (int64_t r = 0; r < N; ++r)
    if (failed[r]) return -1;
  return off[N];
}

}  // extern "C"

// Mock libncbi-vdb for testing the ctypes cursor binding
// (kwage/sriracha/vdb.py) without the real library.
//
// Serves canned per-accession read data from $FAKE_VDB_DIR/<acc>.vdb:
// one line per spot, fragments separated by '|'. Marker files:
//   <acc>.flat       -> PathType reports a flat table (kptTable)
//   <acc>.controlled -> PathType reports kptFile (unauthorized branch)
//   <acc>.flaky      -> first PathType call returns kptNotFound
//   <acc>.cellflaky  -> first VCursorCellDataDirect per row fails once
// Aligned-run layout (the make_bloom.cpp:181-258 ingest shape):
//   <acc>.pal        -> PRIMARY_ALIGNMENT table exists; one aligned READ
//                       per line (row order = stream order)
//   <acc>.palid      -> SEQUENCE PRIMARY_ALIGNMENT_ID column: one line
//                       per spot, '|'-separated int64 ids per fragment
//                       (0 = that fragment is unaligned); absent file =
//                       all zeros (every spot fully unaligned)
//   <acc>.unalbroken -> READ cells fail persistently on a SEQUENCE
//                       cursor that also selected PRIMARY_ALIGNMENT_ID
//                       -- the ncbi-vdb#31 aligned-colorspace bug shape
//                       (reading the unaligned category fails; reading
//                       ALL reads via a plain cursor works)
//
//   <acc>.read2na    -> READ cells report elem_bits=2 (the 2na-packed
//                       column encoding some schema/ABI combinations
//                       serve); the binding must classify it as a clean
//                       READ_FORMAT_ERROR, never decode garbage
//
// ABI-variant builds (tests/test_vdb.py exercises every documented
// pin/fallback against them):
//   -DMOCK_KPT_DATABASE=2 -DMOCK_KPT_TABLE=3
//       older KPathType numbering (the kfs/defs.h values drifted across
//       ncbi-vdb releases; $KWAGE_VDB_KPT_* pins exist for this)
//   -DMOCK_NO_KMETADATA
//       a release predating the KMetadata surface: the cursor streaming
//       API must stay fully usable, meta_available() must be False
//   -DMOCK_NO_NAMELIST
//       a symbol-subset library missing part of the REQUIRED cursor
//       surface: available() must be False (bind-time detection), not
//       a crash at first use
//
// The exported surface matches the subset of the VDB C API the binding
// (and the reference's sra_stream.cpp) uses; rc_t 0 = OK.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace {

struct Accession {
  std::string name;
  std::vector<std::string> spot_seq;                 // concatenated fragments
  std::vector<std::vector<uint32_t>> spot_lens;      // per-fragment lengths
  std::vector<std::vector<int64_t>> spot_palids;     // per-fragment align ids
};

std::string data_dir() {
  const char* d = getenv("FAKE_VDB_DIR");
  return d ? d : ".";
}

bool marker(const std::string& acc, const char* suffix) {
  std::ifstream f(data_dir() + "/" + acc + suffix);
  return f.good();
}

bool load(const std::string& acc, Accession* out) {
  std::ifstream f(data_dir() + "/" + acc + ".vdb");
  if (!f.good()) return false;
  out->name = acc;
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    std::string seq;
    std::vector<uint32_t> lens;
    size_t start = 0;
    while (start <= line.size()) {
      size_t bar = line.find('|', start);
      std::string frag = line.substr(
          start, bar == std::string::npos ? std::string::npos : bar - start);
      seq += frag;
      lens.push_back(static_cast<uint32_t>(frag.size()));
      if (bar == std::string::npos) break;
      start = bar + 1;
    }
    out->spot_seq.push_back(seq);
    out->spot_lens.push_back(lens);
  }
  // PRIMARY_ALIGNMENT_ID sidecar: one line per spot, '|'-separated int64
  // per fragment. Absent -> all zeros (every spot fully unaligned).
  out->spot_palids.assign(out->spot_seq.size(), {});
  for (size_t i = 0; i < out->spot_seq.size(); ++i)
    out->spot_palids[i].assign(out->spot_lens[i].size(), 0);
  std::ifstream pf(data_dir() + "/" + acc + ".palid");
  if (pf.good()) {
    size_t i = 0;
    while (std::getline(pf, line) && i < out->spot_palids.size()) {
      std::vector<int64_t> ids;
      size_t start = 0;
      while (start <= line.size()) {
        size_t bar = line.find('|', start);
        std::string tok = line.substr(
            start, bar == std::string::npos ? std::string::npos : bar - start);
        ids.push_back(tok.empty() ? 0 : std::strtoll(tok.c_str(), nullptr, 10));
        if (bar == std::string::npos) break;
        start = bar + 1;
      }
      out->spot_palids[i++] = ids;
    }
  }
  return true;
}

// PRIMARY_ALIGNMENT table: one aligned READ per line of <acc>.pal
// (single-fragment rows; READ_LEN/PRIMARY_ALIGNMENT_ID never queried).
bool load_pal(const std::string& acc, Accession* out) {
  std::ifstream f(data_dir() + "/" + acc + ".pal");
  if (!f.good()) return false;
  out->name = acc;
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    out->spot_seq.push_back(line);
    out->spot_lens.push_back({static_cast<uint32_t>(line.size())});
    out->spot_palids.push_back({0});
  }
  return true;
}

struct Cursor {
  Accession acc;
  bool open = false;
  bool has_palid_col = false;          // cursor selected PRIMARY_ALIGNMENT_ID
  std::set<int64_t> cell_failed_once;  // rows that already failed once
};

struct Handle {            // manager / db / table all carry the accession
  std::string acc;
  std::string table = "SEQUENCE";
};

std::map<std::string, int> path_type_calls;

#ifndef MOCK_KPT_DATABASE
#define MOCK_KPT_DATABASE 12
#endif
#ifndef MOCK_KPT_TABLE
#define MOCK_KPT_TABLE 13
#endif
const int kMockDatabase = MOCK_KPT_DATABASE;
const int kMockTable = MOCK_KPT_TABLE;

const char* va_path(const char* fmt, va_list ap) {
  // The API is printf-style; both the reference and the binding pass
  // ("%s", accession).
  if (fmt && std::strcmp(fmt, "%s") == 0) return va_arg(ap, const char*);
  return fmt;
}

}  // namespace

extern "C" {

uint32_t VDBManagerMakeRead(void** mgr, void*) {
  *mgr = new Handle();
  return 0;
}
uint32_t VDBManagerRelease(void* mgr) {
  delete static_cast<Handle*>(mgr);
  return 0;
}

int VDBManagerPathType(void*, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string acc = va_path(fmt, ap);
  va_end(ap);
  if (marker(acc, ".flaky") && path_type_calls[acc]++ == 0) return 0;
  if (marker(acc, ".controlled")) return 2;  // kptFile -> default branch
  Accession a;
  if (!load(acc, &a)) return 0;              // kptNotFound
  return marker(acc, ".flat") ? kMockTable : kMockDatabase;
}

uint32_t VDBManagerOpenDBRead(void* mgr, void** db, void*, const char* fmt,
                              ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string acc = va_path(fmt, ap);
  va_end(ap);
  auto* h = new Handle();
  h->acc = acc;
  *db = h;
  return 0;
}
uint32_t VDatabaseRelease(void* db) {
  delete static_cast<Handle*>(db);
  return 0;
}

uint32_t VDBManagerOpenTableRead(void* mgr, void** tbl, void*,
                                 const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string acc = va_path(fmt, ap);
  va_end(ap);
  // Like the real library: a database accession is NOT a flat table
  // (rcTable/rcIncorrect in sra_meta.cpp:42-43); callers fall back to
  // OpenDBRead + SEQUENCE.
  Accession a;
  if (load(acc, &a) && !marker(acc, ".flat")) return 1;
  auto* h = new Handle();
  h->acc = acc;
  *tbl = h;
  return 0;
}
uint32_t VDatabaseOpenTableRead(void* db, void** tbl, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string name = va_path(fmt, ap);
  va_end(ap);
  const std::string acc = static_cast<Handle*>(db)->acc;
  if (name != "SEQUENCE" &&
      !(name == "PRIMARY_ALIGNMENT" && marker(acc, ".pal")))
    return 1;
  auto* h = new Handle();
  h->acc = acc;
  h->table = name;
  *tbl = h;
  return 0;
}
uint32_t VTableRelease(void* tbl) {
  delete static_cast<Handle*>(tbl);
  return 0;
}

// Namelist: {"SEQUENCE"} plus PRIMARY_ALIGNMENT when <acc>.pal exists.
#ifndef MOCK_NO_NAMELIST
uint32_t VDatabaseListTbl(void* db, void** kl) {
  auto* h = new Handle();
  h->acc = static_cast<Handle*>(db)->acc;
  *kl = h;
  return 0;
}
uint32_t KNamelistCount(void* kl, uint32_t* n) {
  *n = marker(static_cast<Handle*>(kl)->acc, ".pal") ? 2 : 1;
  return 0;
}
uint32_t KNamelistGet(void* kl, uint32_t i, const char** name) {
  if (i == 0) { *name = "SEQUENCE"; return 0; }
  if (i == 1 && marker(static_cast<Handle*>(kl)->acc, ".pal")) {
    *name = "PRIMARY_ALIGNMENT";
    return 0;
  }
  return 1;
}
uint32_t KNamelistRelease(void* kl) {
  delete static_cast<Handle*>(kl);
  return 0;
}
#endif  // MOCK_NO_NAMELIST

uint32_t VTableCreateCachedCursorRead(void* tbl, void** cur, size_t) {
  auto* h = static_cast<Handle*>(tbl);
  auto* c = new Cursor();
  const bool ok = h->table == "PRIMARY_ALIGNMENT" ? load_pal(h->acc, &c->acc)
                                                  : load(h->acc, &c->acc);
  if (!ok) {
    delete c;
    return 1;
  }
  *cur = c;
  return 0;
}
uint32_t VCursorRelease(void* cur) {
  delete static_cast<Cursor*>(cur);
  return 0;
}
uint32_t VCursorAddColumn(void* cur, uint32_t* id, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string name = va_path(fmt, ap);
  va_end(ap);
  if (name == "READ") { *id = 1; return 0; }
  if (name == "READ_LEN") { *id = 2; return 0; }
  if (name == "PRIMARY_ALIGNMENT_ID") {
    *id = 3;
    static_cast<Cursor*>(cur)->has_palid_col = true;
    return 0;
  }
  return 1;
}
uint32_t VCursorOpen(void* cur) {
  static_cast<Cursor*>(cur)->open = true;
  return 0;
}
uint32_t VCursorIdRange(void* cur, uint32_t, int64_t* first,
                        uint64_t* count) {
  auto* c = static_cast<Cursor*>(cur);
  *first = 1;  // VDB row ids are 1-based
  *count = c->acc.spot_seq.size();
  return 0;
}
uint32_t VCursorCellDataDirect(void* cur, int64_t row, uint32_t col,
                               uint32_t* elem_bits, void** base,
                               uint32_t* boff, uint32_t* row_len) {
  auto* c = static_cast<Cursor*>(cur);
  if (row < 1 || row > static_cast<int64_t>(c->acc.spot_seq.size())) return 1;
  if (marker(c->acc.name, ".cellflaky") &&
      c->cell_failed_once.insert(row * 10 + col).second) {
    return 1;  // transient failure: the binding must retry
  }
  if (col == 1 && c->has_palid_col && marker(c->acc.name, ".unalbroken")) {
    return 1;  // persistent: the aligned-colorspace bug shape (ncbi-vdb#31)
  }
  const size_t i = static_cast<size_t>(row - 1);
  if (col == 1) {
    // .read2na: a schema/ABI combination serving the packed 2na READ
    // encoding instead of 8-bit ASCII -- the binding must reject it.
    *elem_bits = marker(c->acc.name, ".read2na") ? 2 : 8;
    *base = const_cast<char*>(c->acc.spot_seq[i].data());
    *boff = 0;
    *row_len = static_cast<uint32_t>(c->acc.spot_seq[i].size());
    return 0;
  }
  if (col == 2) {
    *elem_bits = 32;
    *base = c->acc.spot_lens[i].data();
    *boff = 0;
    *row_len = static_cast<uint32_t>(c->acc.spot_lens[i].size());
    return 0;
  }
  if (col == 3) {
    *elem_bits = 64;
    *base = c->acc.spot_palids[i].data();
    *boff = 0;
    *row_len = static_cast<uint32_t>(c->acc.spot_palids[i].size());
    return 0;
  }
  return 1;
}

// ---------------------------------------------------------------------
// KMetadata surface (sra_meta.cpp:17-122): values come from
// $FAKE_VDB_DIR/<acc>.meta lines "BASE_COUNT=N" / "SPOT_COUNT=M".
// Absent file or key -> rc 1 at the corresponding open.
// ---------------------------------------------------------------------

#ifndef MOCK_NO_KMETADATA
uint32_t VDBManagerMakeSRASchema(void*, void** schema) {
  *schema = new Handle();
  return 0;
}
uint32_t VSchemaRelease(void* s) {
  delete static_cast<Handle*>(s);
  return 0;
}
uint32_t VTableOpenKTableRead(void* vtbl, void** ktbl) {
  auto* h = new Handle();
  h->acc = static_cast<Handle*>(vtbl)->acc;
  *ktbl = h;
  return 0;
}
uint32_t KTableRelease(void* k) {
  delete static_cast<Handle*>(k);
  return 0;
}
uint32_t KTableOpenMetadataRead(void* ktbl, void** meta) {
  const std::string acc = static_cast<Handle*>(ktbl)->acc;
  if (!marker(acc, ".meta")) return 1;
  auto* h = new Handle();
  h->acc = acc;
  *meta = h;
  return 0;
}
uint32_t KMetadataRelease(void* m) {
  delete static_cast<Handle*>(m);
  return 0;
}
namespace {
// Both the STATS/TABLE node and its value subnodes are KMDataNodes.
struct MetaNode {
  std::string acc;
  uint64_t value = 0;
};
bool meta_lookup(const std::string& acc, const std::string& key,
                 uint64_t* out) {
  std::ifstream f(data_dir() + "/" + acc + ".meta");
  std::string line;
  while (std::getline(f, line)) {
    size_t eq = line.find('=');
    if (eq == std::string::npos) continue;
    if (line.substr(0, eq) == key) {
      *out = std::strtoull(line.c_str() + eq + 1, nullptr, 10);
      return true;
    }
  }
  return false;
}
}  // namespace

uint32_t KMetadataOpenNodeRead(void* meta, void** node, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string path = va_path(fmt, ap);
  va_end(ap);
  if (path != "STATS/TABLE") return 1;
  auto* h = new MetaNode();
  h->acc = static_cast<Handle*>(meta)->acc;
  *node = h;
  return 0;
}
uint32_t KMDataNodeOpenNodeRead(void* node, void** sub, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string name = va_path(fmt, ap);
  va_end(ap);
  auto* parent = static_cast<MetaNode*>(node);
  uint64_t v;
  if (!meta_lookup(parent->acc, name, &v)) return 1;
  auto* m = new MetaNode();
  m->acc = parent->acc;
  m->value = v;
  *sub = m;
  return 0;
}
uint32_t KMDataNodeReadAsU64(void* sub, uint64_t* out) {
  *out = static_cast<MetaNode*>(sub)->value;
  return 0;
}
uint32_t KMDataNodeRelease(void* sub) {
  delete static_cast<MetaNode*>(sub);
  return 0;
}
#endif  // MOCK_NO_KMETADATA

}  // extern "C"

// kmls_csv — native CSV → dictionary-encoded columnar loader.
//
// A copy of the reference package's loader (native/kmls_csv.cpp), ABI and
// parse semantics unchanged; kmlserver_tpu_torch/data/native.py binds it
// and kmlserver_tpu_torch/data/csv.py::read_tracks reads every dataset
// through it. One pass from the mmap'd file to the representation the
// miner wants:
//
//   - RFC-4180 field scanning (quoted fields, "" escapes, embedded commas
//     and newlines, \r\n);
//   - int64 parse for `pid`;
//   - string interning for every other requested column: per column, an
//     open-addressing hash table over an append-only byte arena produces
//     int32 codes + a first-occurrence vocabulary.
//
// C ABI only (consumed via ctypes). All memory is owned by the kmls_table
// and freed with kmls_table_free.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Arena {
  std::vector<char> bytes;
  std::vector<uint64_t> offsets;  // offsets.size() == count+1

  Arena() { offsets.push_back(0); }

  int32_t add(const char* data, size_t len) {
    bytes.insert(bytes.end(), data, data + len);
    offsets.push_back(bytes.size());
    return static_cast<int32_t>(offsets.size() - 2);
  }
  size_t count() const { return offsets.size() - 1; }
  const char* at(size_t i, size_t* len) const {
    *len = offsets[i + 1] - offsets[i];
    return bytes.data() + offsets[i];
  }
};

// open-addressing intern table over an Arena
struct Interner {
  Arena arena;
  std::vector<int32_t> slots;  // -1 empty, else string id
  size_t mask = 0;

  Interner() { rehash(1 << 12); }

  static uint64_t hash(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (size_t i = 0; i < n; ++i) {
      h ^= static_cast<unsigned char>(s[i]);
      h *= 1099511628211ull;
    }
    return h;
  }

  void rehash(size_t n) {
    std::vector<int32_t> fresh(n, -1);
    for (int32_t id = 0; id < static_cast<int32_t>(arena.count()); ++id) {
      size_t len;
      const char* s = arena.at(id, &len);
      size_t slot = hash(s, len) & (n - 1);
      while (fresh[slot] != -1) slot = (slot + 1) & (n - 1);
      fresh[slot] = id;
    }
    slots.swap(fresh);
    mask = n - 1;
  }

  int32_t intern(const char* s, size_t n) {
    if (arena.count() * 2 >= slots.size()) rehash(slots.size() * 2);
    size_t slot = hash(s, n) & mask;
    while (true) {
      int32_t id = slots[slot];
      if (id == -1) {
        int32_t fresh_id = arena.add(s, n);
        slots[slot] = fresh_id;
        return fresh_id;
      }
      size_t len;
      const char* existing = arena.at(id, &len);
      if (len == n && std::memcmp(existing, s, n) == 0) return id;
      slot = (slot + 1) & mask;
    }
  }
};

struct Column {
  std::string name;
  Interner interner;
  std::vector<int32_t> codes;
};

}  // namespace

// Bumped whenever the exported C surface or parse semantics change; the
// Python binding refuses a .so whose version doesn't match, so a stale
// build from an older checkout can never silently serve the old parser.
#define KMLS_ABI_VERSION 2

extern "C" {

int32_t kmls_abi_version(void) { return KMLS_ABI_VERSION; }

struct kmls_table {
  std::vector<int64_t> pids;
  std::vector<Column> columns;
  std::string error;
};

static void parse_field(const char* p, const char* end, std::string* out,
                        const char** next) {
  out->clear();
  if (p < end && *p == '"') {
    ++p;
    while (p < end) {
      if (*p == '"') {
        if (p + 1 < end && p[1] == '"') {  // escaped quote
          out->push_back('"');
          p += 2;
        } else {
          ++p;
          break;
        }
      } else {
        out->push_back(*p++);
      }
    }
    // trailing junk until delimiter is ignored per RFC leniency
    while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
  } else {
    const char* start = p;
    while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
    out->assign(start, p - start);
  }
  *next = p;
}

// Parse `path`, interning every column except `pid` and any name in the
// comma-separated `skip_cols` list (those are scanned but neither interned
// nor returned — e.g. duration_ms, which the pipeline drops immediately).
// Returns NULL only on allocation failure; check kmls_table_error() for
// parse errors.
kmls_table* kmls_read_csv(const char* path, const char* skip_cols) {
  std::vector<std::string> skip;
  if (skip_cols != nullptr) {
    const char* s = skip_cols;
    while (*s) {
      const char* comma = std::strchr(s, ',');
      size_t len = comma ? static_cast<size_t>(comma - s) : std::strlen(s);
      if (len > 0) skip.emplace_back(s, len);
      s += len + (comma ? 1 : 0);
    }
  }
  auto* table = new kmls_table();
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    table->error = std::string("cannot open ") + path;
    return table;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    table->error = std::string("empty or unreadable ") + path;
    return table;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) {
    table->error = std::string("mmap failed for ") + path;
    return table;
  }
  const char* p = data;
  const char* end = data + size;

  // header. Per-column action: COL_PID parses int64, COL_SKIP is scanned
  // but discarded, >=0 interns into table->columns[action].
  constexpr int COL_PID = -1;
  constexpr int COL_SKIP = -2;
  std::vector<std::string> header;
  std::vector<int> action;
  std::string field;
  int pid_index = -1;
  while (p < end) {
    parse_field(p, end, &field, &p);
    header.push_back(field);
    if (p < end && *p == ',') {
      ++p;
      continue;
    }
    break;
  }
  while (p < end && (*p == '\r' || *p == '\n')) ++p;
  for (size_t i = 0; i < header.size(); ++i) {
    bool skipped = false;
    for (const std::string& s : skip) skipped = skipped || s == header[i];
    if (header[i] == "pid") {
      pid_index = static_cast<int>(i);
      action.push_back(COL_PID);
    } else if (skipped) {
      action.push_back(COL_SKIP);
    } else {
      action.push_back(static_cast<int>(table->columns.size()));
      table->columns.push_back(Column{});
      table->columns.back().name = header[i];
    }
  }
  if (pid_index < 0) {
    table->error = "missing required column 'pid'";
    munmap(const_cast<char*>(data), size);
    return table;
  }

  // rows — buffered per row so nothing is committed until the row's field
  // count and pid both validate (a malformed row must error, not corrupt).
  const int ncols = static_cast<int>(header.size());
  std::vector<std::string> fields(ncols);
  size_t row_no = 0;
  while (p < end) {
    int col = 0;
    bool row_has_data = false;
    bool trailing_comma = false;
    while (p < end && col < ncols) {
      parse_field(p, end, &fields[col], &p);
      if (!fields[col].empty()) row_has_data = true;
      ++col;
      if (p < end && *p == ',') {
        ++p;
        trailing_comma = true;
      } else {
        trailing_comma = false;
        break;
      }
    }
    // a comma consumed right before EOF carries one last EMPTY field that
    // the loop above couldn't enter for (p >= end) — same row WITH a final
    // newline parses that empty field normally, so EOF must match
    if (trailing_comma && p >= end && col < ncols) {
      fields[col].clear();
      ++col;
      trailing_comma = false;
    }
    // a well-formed row ends exactly at EOL/EOF; extra fields after the
    // ncols-th are an error, including a lone trailing empty one (the comma
    // consumed after the last field with nothing but EOL behind it)
    bool at_eol = (p >= end || *p == '\n' || *p == '\r');
    while (p < end && (*p == '\r' || *p == '\n')) ++p;
    if (!row_has_data && col <= 1) continue;  // blank trailing line
    ++row_no;
    if (col != ncols || !at_eol || trailing_comma) {
      char msg[128];
      snprintf(msg, sizeof(msg), "row %zu has %s fields, expected %d",
               row_no, col != ncols ? "too few" : "too many", ncols);
      table->error = msg;
      break;
    }
    const std::string& pid_str = fields[pid_index];
    errno = 0;
    char* endp = nullptr;
    long long pid = strtoll(pid_str.c_str(), &endp, 10);
    if (pid_str.empty() || errno == ERANGE || *endp != '\0') {
      char msg[160];
      snprintf(msg, sizeof(msg), "row %zu: invalid pid '%.64s'",
               row_no, pid_str.c_str());
      table->error = msg;
      break;
    }
    table->pids.push_back(pid);
    for (int i = 0; i < ncols; ++i) {
      int act = action[i];
      if (act >= 0) {
        Column& c = table->columns[act];
        c.codes.push_back(c.interner.intern(fields[i].data(), fields[i].size()));
      }
    }
  }
  munmap(const_cast<char*>(data), size);
  return table;
}

const char* kmls_table_error(kmls_table* t) {
  return t->error.empty() ? nullptr : t->error.c_str();
}

int64_t kmls_table_nrows(kmls_table* t) {
  return static_cast<int64_t>(t->pids.size());
}

const int64_t* kmls_table_pids(kmls_table* t) { return t->pids.data(); }

int32_t kmls_table_ncols(kmls_table* t) {
  return static_cast<int32_t>(t->columns.size());
}

const char* kmls_table_col_name(kmls_table* t, int32_t i) {
  return t->columns[i].name.c_str();
}

const int32_t* kmls_table_col_codes(kmls_table* t, int32_t i) {
  return t->columns[i].codes.data();
}

int32_t kmls_table_col_vocab_size(kmls_table* t, int32_t i) {
  return static_cast<int32_t>(t->columns[i].interner.arena.count());
}

// vocabulary as one concatenated blob + uint64 offsets (count+1 entries)
const char* kmls_table_col_vocab_blob(kmls_table* t, int32_t i, int64_t* nbytes) {
  *nbytes = static_cast<int64_t>(t->columns[i].interner.arena.bytes.size());
  return t->columns[i].interner.arena.bytes.data();
}

const uint64_t* kmls_table_col_vocab_offsets(kmls_table* t, int32_t i) {
  return t->columns[i].interner.arena.offsets.data();
}

void kmls_table_free(kmls_table* t) { delete t; }

}  // extern "C"

// tario — native tar-shard reader for the data plane.
//
// The reference leans on webdataset (Python tarfile) for its shard
// pipeline (training/data.py); at production batch sizes the Python
// header walk + per-member read becomes the host bottleneck.  This
// library does the two hot operations natively:
//
//   * tario_index:  single pass over a tar file collecting
//                   (name, offset, size) for every regular member;
//   * tario_read:   batched positional reads (pread) of members into a
//                   caller-provided arena, parallelized with a small
//                   thread pool.
//
// C ABI for ctypes binding (showo_tpu/data/native_tar.py).  No
// dependencies beyond the C++17 standard library + POSIX.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Member {
  std::string name;
  int64_t offset;
  int64_t size;
};

struct Index {
  std::vector<Member> members;
  // flat name arena for the C API
  std::vector<char> names;
  std::vector<int64_t> name_offsets;
  std::vector<int64_t> offsets;
  std::vector<int64_t> sizes;
};

int64_t parse_octal(const char *p, size_t n) {
  // tar numeric fields: octal ASCII, or base-256 (GNU) with high bit set
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

} // namespace

extern "C" {

// Returns an opaque handle (heap Index*), or nullptr on failure.
void *tario_index(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto *idx = new Index();
  char hdr[512];
  int64_t pos = 0;
  std::string pending_longname;
  while (std::fread(hdr, 1, 512, f) == 512) {
    pos += 512;
    if (hdr[0] == '\0') break; // end-of-archive zero block
    int64_t size = parse_octal(hdr + 124, 12);
    char type = hdr[156];
    std::string name;
    if (!pending_longname.empty()) {
      name = pending_longname;
      pending_longname.clear();
    } else {
      char nbuf[257];
      // ustar prefix field (345, len 155) + name (0, len 100)
      char prefix[156];
      std::memcpy(prefix, hdr + 345, 155);
      prefix[155] = '\0';
      std::memcpy(nbuf, hdr, 100);
      nbuf[100] = '\0';
      if (std::memcmp(hdr + 257, "ustar", 5) == 0 && prefix[0]) {
        name = std::string(prefix) + "/" + nbuf;
      } else {
        name = nbuf;
      }
    }
    int64_t data_blocks = (size + 511) / 512;
    if (type == 'L') { // GNU long name
      std::vector<char> buf(static_cast<size_t>(data_blocks) * 512);
      if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
      pending_longname.assign(buf.data(), static_cast<size_t>(size));
      // strip trailing NUL
      while (!pending_longname.empty() && pending_longname.back() == '\0')
        pending_longname.pop_back();
      pos += data_blocks * 512;
      continue;
    }
    if (type == 'x' || type == 'g') { // PAX extended header: "len key=value\n"
      std::vector<char> buf(static_cast<size_t>(data_blocks) * 512);
      if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
      pos += data_blocks * 512;
      if (type == 'x') {
        const char *p = buf.data();
        const char *end = buf.data() + size;
        while (p < end) {
          char *sp = nullptr;
          long reclen = std::strtol(p, &sp, 10);
          if (reclen <= 0 || !sp || sp >= end) break;
          const char *rec_begin = sp + 1;               // skip the space
          const char *rec_end = p + reclen - 1;         // drop the \n
          std::string rec(rec_begin,
                          static_cast<size_t>(rec_end - rec_begin));
          if (rec.rfind("path=", 0) == 0)
            pending_longname = rec.substr(5);
          p += reclen;
        }
      }
      continue;
    }
    if (type == '0' || type == '\0') {
      idx->members.push_back({name, pos, size});
    }
    if (std::fseek(f, static_cast<long>(data_blocks * 512), SEEK_CUR) != 0)
      break;
    pos += data_blocks * 512;
  }
  std::fclose(f);

  for (auto &m : idx->members) {
    idx->name_offsets.push_back(static_cast<int64_t>(idx->names.size()));
    idx->names.insert(idx->names.end(), m.name.begin(), m.name.end());
    idx->names.push_back('\0');
    idx->offsets.push_back(m.offset);
    idx->sizes.push_back(m.size);
  }
  return idx;
}

int64_t tario_count(void *handle) {
  return static_cast<Index *>(handle)->members.size();
}

const char *tario_name(void *handle, int64_t i) {
  auto *idx = static_cast<Index *>(handle);
  return idx->names.data() + idx->name_offsets[static_cast<size_t>(i)];
}

int64_t tario_size(void *handle, int64_t i) {
  return static_cast<Index *>(handle)->sizes[static_cast<size_t>(i)];
}

int64_t tario_offset(void *handle, int64_t i) {
  return static_cast<Index *>(handle)->offsets[static_cast<size_t>(i)];
}

void tario_free(void *handle) { delete static_cast<Index *>(handle); }

// Read `n` members (by index) into `out`, packed back-to-back in the given
// order; `out_offsets[i]` receives the start of member i in `out`.
// Returns total bytes read, or -1 on error.
int64_t tario_read(const char *path, void *handle, const int64_t *indices,
                   int64_t n, char *out, int64_t out_capacity,
                   int64_t *out_offsets, int num_threads) {
  auto *idx = static_cast<Index *>(handle);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    out_offsets[i] = total;
    total += idx->sizes[static_cast<size_t>(indices[i])];
  }
  if (total > out_capacity) return -1;

  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;

  std::atomic<int64_t> next{0};
  std::atomic<bool> ok{true};
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      const auto mi = static_cast<size_t>(indices[i]);
      int64_t remaining = idx->sizes[mi];
      int64_t off = idx->offsets[mi];
      char *dst = out + out_offsets[i];
      while (remaining > 0) {
        ssize_t r = ::pread(fd, dst, static_cast<size_t>(remaining), off);
        if (r <= 0) {
          ok = false;
          return;
        }
        remaining -= r;
        off += r;
        dst += r;
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 4;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
  ::close(fd);
  return ok ? total : -1;
}

} // extern "C"

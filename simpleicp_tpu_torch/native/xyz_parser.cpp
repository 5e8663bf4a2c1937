// xyz point-cloud reader: mmap, line-aligned chunks over std::thread, and
// correctly rounded std::from_chars, so that every value is bit-equal to
// np.loadtxt(path, comments="//", ndmin=2) wherever numpy accepts the file.
//
// Contract: one `x y z` triple per line, separated by spaces, tabs, \v or
// \f; lines end in \n, \r\n or a lone \r (numpy reads the file with
// universal newlines); blank lines are skipped; "//" starts a comment that
// runs to the end of its line (a CloudCompare header, or after the three
// values); exactly three numeric columns; a leading '+' is accepted, as
// numpy accepts it (from_chars does not); values out of range become +-inf
// or a correctly rounded subnormal or zero, as in numpy. The first
// malformed line is reported by its 1-based global line number, the same
// line a serial parse stops at.
//
// C ABI (ctypes, native/__init__.py):
//   int64_t xyz_count_and_parse(const char* path, double* out /* or null */,
//                               int64_t capacity, char* errbuf, int64_t errlen);
// With out == null: the number of point lines (no numeric validation).
// With out: parses every point line into out[3 * row + column] and returns
// the number of points, or -1 with a message in errbuf.

#include <cmath>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline bool is_blank(char c) { return c == ' ' || c == '\t' || c == '\v' || c == '\f'; }

inline bool at_comment(const char* p, const char* le) {
  return p + 1 < le && p[0] == '/' && p[1] == '/';
}

// The line starting at p: its end le (the terminator or the end of the
// range) and the start of the next line.
inline const char* line_end(const char* p, const char* end, const char*& next) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
  const char* stop = nl ? nl : end;
  const char* cr = static_cast<const char*>(memchr(p, '\r', static_cast<size_t>(stop - p)));
  if (cr) {
    next = (cr + 1 == nl) ? nl + 1 : cr + 1;
    return cr;
  }
  next = nl ? nl + 1 : end;
  return stop;
}

// True when [p, le) holds a point: something other than blanks before the
// end of the line or a comment.
inline bool is_point_line(const char* p, const char* le) {
  while (p < le && is_blank(*p)) ++p;
  return p < le && !at_comment(p, le);
}

// One field at p within the line [p, le): a number that ends at a blank,
// the line's end or a comment. Advances p past it.
inline bool parse_field(const char*& p, const char* le, double& out) {
  while (p < le && is_blank(*p)) ++p;
  if (p >= le || at_comment(p, le)) return false;
  const char* s = p;
  if (*s == '+') {  // from_chars takes '-' only
    ++s;
    if (s >= le || *s == '+' || *s == '-') return false;
  }
  auto [q, ec] = std::from_chars(s, le, out);
  if (ec == std::errc::invalid_argument) return false;
  if (q < le && !is_blank(*q) && !at_comment(q, le)) return false;
  if (ec == std::errc::result_out_of_range) {
    // from_chars leaves out unset here; strtod gives what numpy gives:
    // +-inf on overflow, the correctly rounded subnormal or zero below.
    std::string tok(s, q);
    out = strtod(tok.c_str(), nullptr);
  } else if (std::isnan(out) && memchr(s, '(', static_cast<size_t>(q - s))) {
    return false;  // from_chars takes "nan(chars)", numpy does not
  }
  p = q;
  return true;
}

// Lines and point lines of [p, end): places each chunk's first line number
// and first output row before the parallel parse.
void count_range(const char* p, const char* end, int64_t& lines, int64_t& points) {
  lines = points = 0;
  while (p < end) {
    const char* next;
    const char* le = line_end(p, end, next);
    ++lines;
    if (is_point_line(p, le)) ++points;
    p = next;
  }
}

// Parses [p, end), whose first line is line base_line + 1, writing its
// points from row out_row on. Returns the number of points, or -1 with
// err_line and err_msg set at the first malformed line.
int64_t parse_range(const char* p, const char* end, int64_t base_line, double* out,
                    int64_t out_row, int64_t capacity, int64_t& err_line,
                    const char*& err_msg) {
  int64_t line = base_line;
  int64_t row = out_row;
  while (p < end) {
    const char* next;
    const char* le = line_end(p, end, next);
    ++line;
    if (is_point_line(p, le)) {
      double v[3];
      const char* q = p;
      if (!parse_field(q, le, v[0]) || !parse_field(q, le, v[1]) ||
          !parse_field(q, le, v[2])) {
        err_msg = "expected 3 numeric columns";
      } else {
        while (q < le && is_blank(*q)) ++q;
        if (q < le && !at_comment(q, le)) {
          err_msg = "more than 3 columns";
        } else if (row >= capacity) {
          err_msg = "more points than counted";
        }
      }
      if (err_msg != nullptr) {
        err_line = line;
        return -1;
      }
      out[3 * row + 0] = v[0];
      out[3 * row + 1] = v[1];
      out[3 * row + 2] = v[2];
      ++row;
    }
    p = next;
  }
  return row - out_row;
}

void set_err(char* errbuf, int64_t errlen, const char* msg, int64_t line) {
  if (errbuf && errlen > 0) {
    if (line > 0)
      snprintf(errbuf, static_cast<size_t>(errlen), "%s (line %lld)", msg,
               static_cast<long long>(line));
    else
      snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg);
  }
}

// Files below this size parse on the calling thread: starting threads and
// the extra counting pass would cost more than they save.
constexpr size_t kParallelMinBytes = size_t{4} << 20;
constexpr unsigned kMaxThreads = 16;

// f(0) ... f(n - 1), each on a thread of its own (on this one when n == 1).
template <class F>
void run_chunks(size_t n, F&& f) {
  if (n == 1) {
    f(size_t{0});
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n);
  for (size_t i = 0; i < n; ++i) pool.emplace_back(f, i);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" int64_t xyz_count_and_parse(const char* path, double* out, int64_t capacity,
                                       char* errbuf, int64_t errlen) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    set_err(errbuf, errlen, "cannot open file", 0);
    return -1;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    set_err(errbuf, errlen, "cannot stat file", 0);
    return -1;
  }
  const size_t size = static_cast<size_t>(st.st_size);
  if (size == 0) {  // no data: numpy returns an empty array
    close(fd);
    return 0;
  }
  void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) {
    set_err(errbuf, errlen, "mmap failed", 0);
    return -1;
  }
  madvise(map, size, MADV_SEQUENTIAL);
  const char* base = static_cast<const char*>(map);
  const char* end = base + size;

  const unsigned hw = std::thread::hardware_concurrency();
  const size_t nc = (size < kParallelMinBytes || hw < 2) ? 1 : (hw < kMaxThreads ? hw : kMaxThreads);
  // Chunk starts: byte offsets moved forward past the next '\n', so that
  // every line (\r\n included) lies in one chunk.
  std::vector<const char*> starts(nc + 1, end);
  starts[0] = base;
  for (size_t i = 1; i < nc; ++i) {
    const char* pos = base + size / nc * i;
    if (pos < starts[i - 1]) pos = starts[i - 1];
    const char* nl = static_cast<const char*>(memchr(pos, '\n', static_cast<size_t>(end - pos)));
    starts[i] = nl ? nl + 1 : end;
  }

  // Pass 1 (skipped by a serial fill): lines and point lines of each chunk.
  std::vector<int64_t> lines(nc, 0), points(nc, 0);
  int64_t result = 0;
  if (out == nullptr || nc > 1) {
    run_chunks(nc, [&](size_t i) { count_range(starts[i], starts[i + 1], lines[i], points[i]); });
    for (size_t i = 0; i < nc; ++i) result += points[i];
  }
  if (out != nullptr) {
    // Pass 2. Exclusive prefix sums: chunk i's first line is line_base[i] + 1
    // and its first point goes to row row_base[i].
    std::vector<int64_t> line_base(nc, 0), row_base(nc, 0), parsed(nc, 0), err_line(nc, 0);
    std::vector<const char*> err_msg(nc, nullptr);
    for (size_t i = 1; i < nc; ++i) {
      line_base[i] = line_base[i - 1] + lines[i - 1];
      row_base[i] = row_base[i - 1] + points[i - 1];
    }
    run_chunks(nc, [&](size_t i) {
      parsed[i] = parse_range(starts[i], starts[i + 1], line_base[i], out, row_base[i],
                              capacity, err_line[i], err_msg[i]);
    });
    result = 0;
    for (size_t i = 0; i < nc; ++i) {
      if (err_msg[i] != nullptr) {  // the first chunk with an error holds the first bad line
        set_err(errbuf, errlen, err_msg[i], err_line[i]);
        result = -1;
        break;
      }
      result += parsed[i];
    }
  }
  munmap(map, size);
  return result;
}

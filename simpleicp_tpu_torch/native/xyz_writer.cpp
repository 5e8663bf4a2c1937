// xyz point-cloud writer: the rows formatted over std::thread and written in
// order, byte-identical to np.savetxt(fmt="%.<decimals>f", delimiter=" ")
// under the header.
//
// Every finite value goes through fmt_fixed, an exact integer conversion
// of the double (m * 2^-s) scaled by 10^decimals in 128-bit arithmetic
// with the remainder rounded half to even: the correctly rounded decimal
// that printf and Python's "%" formatting give, "-0.000" included. Values
// it cannot hold (|v| >= 2^52, a scaled value above 2^63, more than 12
// decimals) go to snprintf, which is exact too. NaN prints as "nan" and
// the infinities as "inf" and "-inf", as Python prints them (printf would
// print "-nan" for a NaN with its sign bit set).
//
// C ABI (ctypes, native/__init__.py):
//   int64_t xyz_write(const char* path, const double* X /* (n, 3), C order */,
//                     int64_t n, int32_t decimals, const char* header,
//                     char* errbuf, int64_t errlen);
// header is written first, as it is. Returns 0, or -1 with a message in
// errbuf.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

void set_err(char* errbuf, int64_t errlen, const char* msg) {
  if (errbuf && errlen > 0) snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg);
}

__extension__ typedef unsigned __int128 u128;

// "%.<dec>f" of v into out (at least 24 + dec bytes), or -1 when v is
// out of this conversion's range. p10 = 10^dec.
inline int fmt_fixed(char* out, double v, int dec, uint64_t p10) {
  uint64_t bits;
  memcpy(&bits, &v, 8);
  const bool neg = (bits >> 63) != 0;
  const int biased = static_cast<int>((bits >> 52) & 0x7ff);
  if (biased == 0x7ff || biased >= 1075 || dec > 12) return -1;
  // |v| < 2^52: v = m / 2^s exactly, with s >= 1
  const uint64_t m = (bits & ((uint64_t{1} << 52) - 1)) | (biased ? (uint64_t{1} << 52) : 0);
  const int s = biased ? (1075 - biased) : 1074;
  uint64_t q;
  if (s > 100) {
    // |v| < 2^-47, so v * 10^12 < 2^-7 < 1/2: rounds to 0
    q = 0;
  } else {
    const u128 prod = static_cast<u128>(m) * p10;
    const u128 qw = prod >> s;
    if (qw >> 63) return -1;
    q = static_cast<uint64_t>(qw);
    const u128 r = prod - (qw << s);
    const u128 half = static_cast<u128>(1) << (s - 1);
    if (r > half || (r == half && (q & 1))) ++q;
  }
  char digits[24];  // q backwards (at most 20 digits)
  int nd = 0;
  do {
    digits[nd++] = static_cast<char>('0' + (q % 10));
    q /= 10;
  } while (q != 0);
  char* w = out;
  if (neg) *w++ = '-';
  if (nd > dec) {
    for (int i = nd - 1; i >= dec; --i) *w++ = digits[i];
  } else {
    *w++ = '0';
  }
  if (dec > 0) {
    *w++ = '.';
    for (int i = dec - 1; i >= 0; --i) *w++ = (i < nd) ? digits[i] : '0';
  }
  return static_cast<int>(w - out);
}

void append_value(std::string& buf, double v, int dec, uint64_t p10) {
  char fast[48];
  const int len = fmt_fixed(fast, v, dec, p10);
  if (len >= 0) {
    buf.append(fast, static_cast<size_t>(len));
  } else if (std::isnan(v)) {
    buf += "nan";
  } else if (std::isinf(v)) {
    buf += v < 0 ? "-inf" : "inf";
  } else {
    const int need = snprintf(nullptr, 0, "%.*f", dec, v);
    std::string wide(static_cast<size_t>(need) + 1, '\0');
    snprintf(&wide[0], wide.size(), "%.*f", dec, v);
    buf.append(wide.data(), static_cast<size_t>(need));
  }
}

// Rows below this count are formatted on the calling thread.
constexpr int64_t kParallelMinRows = int64_t{1} << 18;
constexpr unsigned kMaxThreads = 16;

}  // namespace

extern "C" int64_t xyz_write(const char* path, const double* X, int64_t n, int32_t decimals,
                             const char* header, char* errbuf, int64_t errlen) {
  if (n < 0 || decimals < 0) {
    set_err(errbuf, errlen, "invalid arguments");
    return -1;
  }
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t n_ch = (n < kParallelMinRows || hw < 2) ? 1 : (hw < kMaxThreads ? hw : kMaxThreads);
  uint64_t p10 = 1;
  for (int d = 0; d < decimals && d < 13; ++d) p10 *= 10;

  std::vector<std::string> bufs(static_cast<size_t>(n_ch));
  auto format = [&](int64_t c) {
    const int64_t i0 = n * c / n_ch, i1 = n * (c + 1) / n_ch;
    std::string& buf = bufs[static_cast<size_t>(c)];
    buf.reserve(static_cast<size_t>(i1 - i0) * static_cast<size_t>(3 * (12 + decimals) + 3));
    for (int64_t i = i0; i < i1; ++i) {
      const double* row = X + 3 * i;
      append_value(buf, row[0], decimals, p10);
      buf += ' ';
      append_value(buf, row[1], decimals, p10);
      buf += ' ';
      append_value(buf, row[2], decimals, p10);
      buf += '\n';
    }
  };
  if (n_ch == 1) {
    format(0);
  } else {
    std::vector<std::thread> pool;
    for (int64_t c = 0; c < n_ch; ++c) pool.emplace_back(format, c);
    for (auto& t : pool) t.join();
  }

  FILE* f = fopen(path, "wb");
  if (!f) {
    set_err(errbuf, errlen, "cannot open file for writing");
    return -1;
  }
  bool ok = true;
  const size_t hlen = header ? strlen(header) : 0;
  if (hlen) ok = fwrite(header, 1, hlen, f) == hlen;
  for (const std::string& buf : bufs) {
    if (!ok) break;
    ok = buf.empty() || fwrite(buf.data(), 1, buf.size(), f) == buf.size();
  }
  if (fclose(f) != 0) ok = false;
  if (!ok) {
    set_err(errbuf, errlen, "write failed");
    return -1;
  }
  return 0;
}

"""The port's native xyz reader and writer (``simpleicp_tpu_torch/native/``)
against numpy and the JAX package.

The reader is held bit for bit to ``np.loadtxt(path, comments="//",
ndmin=2)`` (``read_xyz_plain``), the writer byte for byte to ``np.savetxt``
(``write_xyz_plain``) and to the JAX package's native writer. The JAX
package's parser rounds some values 1-2 ulp away from the exact decimal;
the port's does not, and the comparison counts those values.
"""

import contextlib

import numpy as np
import pytest

from simpleicp_tpu.utils import xyz_io as jio
from simpleicp_tpu_torch import _build, native
from simpleicp_tpu_torch.utils import xyz_io as tio
from simpleicp_tpu_torch.utils.xyz_io import XyzIOError

# Files the reader must read as numpy does.
READER_CASES = {
    "leading plus": "+1.5 +.25 +1e3\n-2 +0 3\n",
    "exponents": "1e3 -2.5E-3 6.02e+23\n1e-310 1e400 -1e-400\n",
    "crlf": "//X Y Z\r\n1 2 3\r\n4.5 5.5 6.5\r\n",
    "lone cr": "1 2 3\r4 5 6\r",
    "tabs and blanks": "\t1\t2 \t3  \n \x0b\x0c\n  -4 5\t-6\t\n",
    "blank lines": "\n\n1 2 3\n\n   \n4 5 6\n\n",
    "header": "//X Y Z\n0.125 -0.250 0.500\n// a note\n1 2 3\n",
    "trailing comment": "1 2 3 // first\n4 5 6//second\n",
    "no trailing newline": "//X Y Z\n1 2 3\n4 5 6",
    "inf and nan": "inf -inf nan\nInfinity -NaN +inf\n",
    "negative zero": "-0 -0.000 0.0\n",
    "header only": "//X Y Z\n",
    "empty": "",
}


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return path


def _assert_bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_bit_equal_to_loadtxt(tmp_path, case):
    f = _write(tmp_path / "c.xyz", READER_CASES[case])
    no_data = case in ("empty", "header only")  # loadtxt warns of no data
    with pytest.warns(UserWarning) if no_data else contextlib.nullcontext():
        want = tio.read_xyz_plain(f)
    got = tio.read_xyz(f)
    _assert_bit_equal(got, want)
    assert got.shape[1] == 3
    assert tio.read_xyz(f, dtype=np.float32).dtype == np.float32


def _big_file(tmp_path, rng, n=200_000, fmt="%.6f"):
    """About 6 MB at %.6f, above the 4 MB where the reader splits the file
    into chunks on several threads."""
    X = rng.uniform(-1000.0, 1000.0, (n, 3))
    f = tmp_path / "big.xyz"
    tio.write_xyz_plain(f, X, fmt=fmt)
    assert f.stat().st_size > (4 << 20)
    return f, X


def test_reader_chunked_file_bit_equal_and_first_error_line(tmp_path):
    """A file above the chunking threshold reads bit-equal to loadtxt; a
    malformed line deep in it, and a second one after it, make the reader
    name the first one by its 1-based line number, as a serial parse
    would."""
    rng = np.random.default_rng(5)
    f, _ = _big_file(tmp_path, rng)
    _assert_bit_equal(tio.read_xyz(f), tio.read_xyz_plain(f))
    lines = f.read_text().splitlines(keepends=True)
    bad = 150_001  # 1-based, in a late chunk
    lines[bad - 1] = "1.0 2.0\n"
    lines[bad + 20_000] = "not a point\n"
    f.write_text("".join(lines))
    with pytest.raises(XyzIOError, match=rf"\(line {bad}\)"):
        tio.read_xyz(f)


def test_reader_errors(tmp_path):
    with pytest.raises(XyzIOError, match="does not exist"):
        tio.read_xyz(tmp_path / "missing.xyz")
    f = _write(tmp_path / "two.xyz", "//X Y\n1 2\n3 4\n")
    with pytest.raises(XyzIOError, match=r"expected 3 numeric columns \(line 2\)"):
        tio.read_xyz(f)
    f = _write(tmp_path / "four.xyz", "1 2 3\n\n1 2 3 4\n")
    with pytest.raises(XyzIOError, match=r"more than 3 columns \(line 3\)"):
        tio.read_xyz(f)
    # tokens numpy refuses are refused too
    for i, text in enumerate(("+-1 2 3\n", "nan(1) 2 3\n", "1e 2 3\n", "0x10 2 3\n",
                              "1,2,3\n", "1 2 3 /\n")):
        f = _write(tmp_path / f"bad{i}.xyz", text)
        with pytest.raises(XyzIOError):
            tio.read_xyz_plain(f)
        with pytest.raises(XyzIOError, match=r"\(line 1\)"):
            tio.read_xyz(f)


def test_reader_exact_where_the_jax_parser_rounds(tmp_path):
    """On a %.6f file the JAX package's reader is within 2 ulp of the port's
    and differs in some values; the port's equals loadtxt in all."""
    rng = np.random.default_rng(6)
    X = rng.uniform(-1000.0, 1000.0, (20_000, 3))
    f = tmp_path / "p.xyz"
    tio.write_xyz(f, X, fmt="%.6f")
    got, jax_got = tio.read_xyz(f), jio.read_xyz(str(f))
    _assert_bit_equal(got, tio.read_xyz_plain(f))
    ulp = np.spacing(np.abs(got))
    assert np.all(np.abs(jax_got - got) <= 2 * ulp)
    assert np.count_nonzero(jax_got != got) > 0


# Rows the writer must format as np.savetxt does: ties at the printed
# digit, signed zeros, large and tiny magnitudes, and the non-finite values.
WRITER_ROWS = np.array([
    [0.0625, 2.5, -0.0005],
    [0.5, 1.5, -2.5],
    [-0.0, 0.0, -1e-7],
    [1e12, -1e12, 123456.7890125],
    [2.0 ** 52, 1e17, 1e300],
    [5e-324, 1e-300, 0.1],
    [np.inf, -np.inf, np.nan],
    [-np.nan, 1.0, 2.0],
])


@pytest.mark.parametrize("fmt", ["%.3f", "%.6f", "%.9f"])
def test_writer_byte_equal_to_savetxt_and_jax(tmp_path, fmt):
    rng = np.random.default_rng(7)
    X = np.concatenate([WRITER_ROWS, rng.uniform(-1e4, 1e4, (3000, 3)),
                        np.round(rng.uniform(-100, 100, (1000, 3)), 4) + 5e-5])
    a, b, c = (tmp_path / f"{k}.xyz" for k in "abc")
    tio.write_xyz(a, X, fmt=fmt)
    tio.write_xyz_plain(b, X, fmt=fmt)
    assert a.read_bytes() == b.read_bytes()
    # The JAX writer prints "-nan" for a NaN with its sign bit set (printf);
    # numpy and the port print "nan". Every other row is byte-equal.
    keep = ~(np.isnan(X) & np.signbit(X)).any(axis=1)
    tio.write_xyz(a, X[keep], fmt=fmt)
    jio.write_xyz(c, X[keep], fmt=fmt)
    assert a.read_bytes() == c.read_bytes()


def test_writer_threads_and_other_formats(tmp_path):
    """From 2^18 rows the writer formats on several threads: still equal to
    savetxt. Formats other than %.Nf go to savetxt itself."""
    rng = np.random.default_rng(8)
    X = rng.uniform(-1e3, 1e3, ((1 << 18) + 17, 3))
    a, b = tmp_path / "a.xyz", tmp_path / "b.xyz"
    tio.write_xyz(a, X, fmt="%.3f")
    tio.write_xyz_plain(b, X, fmt="%.3f")
    assert a.read_bytes() == b.read_bytes()
    _assert_bit_equal(tio.read_xyz(a), tio.read_xyz_plain(b))
    tio.write_xyz(a, X[:50], fmt="%.4e")
    tio.write_xyz_plain(b, X[:50], fmt="%.4e")
    assert a.read_bytes() == b.read_bytes() and b"e+" in a.read_bytes()


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A missing or failing host compiler makes read_xyz and write_xyz raise
    RuntimeError with the compiler's output; nothing reads with numpy."""
    f = _write(tmp_path / "ok.xyz", "1 2 3\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="compiler .* not found"):
        tio.read_xyz(f)
    monkeypatch.setenv("CXX", "false")  # exits 1
    with pytest.raises(RuntimeError, match="false failed on xyz_parser.cpp, xyz_writer.cpp"):
        tio.read_xyz(f)
    with pytest.raises(RuntimeError):
        tio.write_xyz(tmp_path / "out.xyz", np.zeros((2, 3)))
    assert native._lib is None

"""Host-side helpers: xyz file I/O and counted flag reads."""

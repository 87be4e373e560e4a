"""Host C++ volume readers, loaded through ctypes and built at first use
(`build.py`)."""

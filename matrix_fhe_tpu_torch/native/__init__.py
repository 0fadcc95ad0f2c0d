"""Native (C++) host-side table generator, bound with ctypes."""

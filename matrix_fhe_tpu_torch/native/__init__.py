"""Native (C++) host-side code bound with ctypes: the table generator
(tablegen) and the independent golden-model oracle (golden)."""

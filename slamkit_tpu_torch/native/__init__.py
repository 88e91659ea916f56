"""Host-side C++ libraries, built with g++ at first use (`_build.py`):
the libav audio decoder (`audio.cpp`, `bindings.py`), the unit-string codec
(`codec.cpp`, `codec.py`) and the packing recurrences (`pack.cpp`,
`pack.py`). Copies of `slamkit_tpu/native/`'s sources and bindings."""
